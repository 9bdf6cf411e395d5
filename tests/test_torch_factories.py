"""The port's factories against the JAX package's on the names they refuse.

An unknown `model.decoder_type` and an unknown `model.type` raise
ValueError in both packages, with the same message
(isopoints_tpu/factories.py:35,79). A dotted `decoder_type` is a class
path, which the JAX package resolves (factories.py:29-30); for it the port
raises NotImplementedError naming ROADMAP Queue 1 item 3, since such a
path written for JAX names an `isopoints_tpu` class the port may not
import.
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
    dotted = "isopoints_tpu.models.fields.SDFField"
    jcfg, tcfg = _configs(decoder_type=dotted)
    assert isinstance(j_create_decoder(jcfg), JSDF)      # JAX resolves the path
    with pytest.raises(NotImplementedError, match="item 3"):
        create_decoder(tcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="item 3"):
        create_model(tcfg, device="cpu")
