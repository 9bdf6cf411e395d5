"""The port's factories against the JAX package's on the names they refuse,
and on the keys and arguments that both take.

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


@pytest.mark.parametrize("n", [100, 24])
def test_n_points_per_ray_builds_in_both(n):
    """`implicit_kwargs.n_points_per_ray` (implicit.py:70) builds in both
    packages and reaches the model's config."""
    jcfg, tcfg = _configs()
    for c in (jcfg, tcfg):
        c.model.implicit_kwargs.update(n_points_per_ray=n)
    assert j_create_model(jcfg).cfg.n_points_per_ray == n
    model = create_model(tcfg, device="cpu")
    assert model.cfg.n_points_per_ray == n
    from isopoints_tpu.models.implicit import ImplicitConfig as JCfg
    from isopoints_torch.models.implicit import ImplicitConfig
    assert ImplicitConfig().n_points_per_ray == JCfg().n_points_per_ray == 100


def test_create_dataset_takes_mode():
    """JAX's `create_dataset(cfg, mode)` never reads `mode`; neither does
    the port's: both modes give the same arrays."""
    import numpy as np
    from isopoints_torch.factories import create_dataset
    _, tcfg = _configs()
    tcfg.data.update(type="synthetic", sdf="sphere", n_views=2, image_size=16)
    a = create_dataset(tcfg, "train", device="cpu")
    b = create_dataset(tcfg, mode="val", device="cpu")
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
