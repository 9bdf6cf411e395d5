"""The port's factories against the JAX package's on the names they refuse.

An unknown `model.decoder_type` and an unknown `model.type` raise
ValueError in both packages, with the same message
(isopoints_tpu/factories.py:35,79). A dotted `decoder_type` is a class
path, which the JAX package resolves (factories.py:29-30); the port
resolves it inside `isopoints_torch`, reading a leading `isopoints_tpu.`
as `isopoints_torch.`, and a path that names no class of the port raises
JAX's ValueError for an unknown decoder_type.
"""

import pytest

from isopoints_tpu.config import default_config_path as j_default
from isopoints_tpu.config import load_config as j_load
from isopoints_tpu.factories import create_decoder as j_create_decoder
from isopoints_tpu.factories import create_model as j_create_model
from isopoints_tpu.models.fields import SDFField as JSDF
from isopoints_torch.config import default_config_path, load_config
from isopoints_torch.factories import create_decoder, create_model


def _configs(**model):
    jcfg, tcfg = j_load(j_default()), load_config(default_config_path())
    for c in (jcfg, tcfg):
        c.model.decoder_kwargs.update(hidden_size=16, n_layers=1)
        c.model.update(model)
    return jcfg, tcfg


@pytest.mark.parametrize("model", [{"decoder_type": "nosuch"},
                                   {"type": "nosuch"}],
                         ids=["decoder_type", "model_type"])
def test_unknown_type_raises_the_references_value_error(model):
    jcfg, tcfg = _configs(**model)
    with pytest.raises(ValueError) as j_err:
        j_create_model(jcfg)
    with pytest.raises(ValueError) as t_err:
        create_model(tcfg, device="cpu")
    assert str(t_err.value) == str(j_err.value)
    assert str(t_err.value) == f"unknown {'decoder_type' if 'decoder_type' in model else 'model type'} nosuch"


def test_dotted_decoder_type_raises_not_implemented():
    """The dotted path resolves to the port's class with the config's
    kwargs, as JAX resolves its own; a path naming no class of the port
    raises JAX's message."""
    from isopoints_torch.models.fields import SDFField
    for dotted in ("isopoints_tpu.models.fields.SDFField",
                   "isopoints_torch.models.fields.SDFField"):
        jcfg, tcfg = _configs(decoder_type=dotted)
        j_dec = j_create_decoder(jcfg) if "tpu" in dotted else None
        dec = create_decoder(tcfg, device="cpu")
        assert isinstance(dec, SDFField) and dec.hidden_size == 16
        if j_dec is not None:
            assert isinstance(j_dec, JSDF) and j_dec.dims == dec.dims
        model = create_model(tcfg, device="cpu")
        assert isinstance(model.decoder, SDFField)
    for bad in ("isopoints_torch.models.fields.NoSuch", "numpy.ndarray"):
        _, tcfg = _configs(decoder_type=bad)
        with pytest.raises(ValueError) as t_err:
            create_decoder(tcfg, device="cpu")
        assert str(t_err.value) == f"unknown decoder_type {bad}"
