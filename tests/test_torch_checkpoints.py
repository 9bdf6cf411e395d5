"""Port parity: the sharding-aware checkpoint backend
(isopoints_torch/misc/checkpoints.py, `backend="orbax"` on
torch.distributed.checkpoint) against the JAX package's orbax backend, on
the CPU.

- The JAX tests' round trip (tests/test_training.py::TestCheckpointIO
  `test_orbax_backend_roundtrip`): the same registry and scalars saved by
  both packages land at the same `<stem>.orbax` path, and loaded into
  zeroed templates (plus an entry the checkpoint lacks, kept) they restore
  the same values, exactly.
- `test_orbax_restores_optax_state`'s regression on the port: the Adam
  state after one `clip_and_adam` step (non-zero moments, an integer
  count, a NamedTuple of dicts keyed by dotted parameter names) restores
  bit for bit, and equals what JAX's backend restores from the same
  values.
- Under 2 gloo ranks (tests/torch_parallel_worker.py "checkpoint"): both
  ranks save and load collectively; the replicated entries are written
  once (each in one rank's file), the row-sharded DTensor as each rank's
  shard; every rank restores every value exactly, the DTensor as its own
  shard.
- Neither package reads the other's directory.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from isopoints_tpu.misc.checkpoints import CheckpointIO as JCheckpointIO
from isopoints_torch.misc.checkpoints import CheckpointIO
from isopoints_torch.training.trainer import AdamState, clip_and_adam
from test_torch_parallel import spawn


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _registry(seed=0):
    rng = np.random.RandomState(seed)
    return {"w": rng.normal(size=(2, 3)).astype(np.float32),
            "pts": np.arange(16.0, dtype=np.float32).reshape(-1, 1),
            "mask": rng.uniform(size=5) > 0.5}


def test_orbax_round_trip_against_jax(tmp_path):
    reg = _registry()
    jpath = JCheckpointIO(str(tmp_path / "jax"), backend="orbax",
                          model={k: jnp.asarray(v) for k, v in reg.items()}
                          ).save("model", it=7, loss_val_best=0.25)
    tpath = CheckpointIO(str(tmp_path / "port"), backend="orbax",
                         model={k: torch.from_numpy(v) for k, v in reg.items()}
                         ).save("model", it=7, loss_val_best=0.25)
    assert os.path.basename(tpath) == os.path.basename(jpath) == "model.orbax"
    j2 = JCheckpointIO(str(tmp_path / "jax"), backend="orbax",
                       model={**{k: jnp.zeros_like(v) for k, v in reg.items()},
                              "extra": jnp.full(2, 3.0)})
    t2 = CheckpointIO(str(tmp_path / "port"), backend="orbax",
                      model={**{k: torch.zeros_like(torch.from_numpy(v))
                                for k, v in reg.items()},
                             "extra": torch.full((2,), 3.0)})
    js, ts = j2.load("model"), t2.load("model")
    assert js == ts == {"it": 7, "loss_val_best": 0.25}
    for k in list(reg) + ["extra"]:
        got, ref = t2.registry["model"][k].numpy(), np.asarray(j2.registry["model"][k])
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref, err_msg=k)
    np.testing.assert_array_equal(t2.registry["model"]["extra"].numpy(), np.full(2, 3.0))
    # each package's directory holds its own format
    assert ".metadata" in os.listdir(tpath)
    with pytest.raises(Exception):
        CheckpointIO(str(tmp_path / "jax"), backend="orbax").read("model")


def _adam_step():
    """The port's clip + Adam after one step on a small net: non-zero
    moments, count 1."""
    g = torch.Generator().manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 1))
    params = dict(net.named_parameters())
    zeros = {k: torch.zeros_like(p) for k, p in params.items()}
    grads = {k: torch.rand(p.shape, generator=g) * 0.1 for k, p in params.items()}
    with torch.no_grad():
        st = clip_and_adam(params, grads, AdamState(0, zeros, dict(zeros)), 1e-3, 1.0)
    return net, st


def test_orbax_restores_adam_state(tmp_path):
    net, st = _adam_step()
    CheckpointIO(str(tmp_path), backend="orbax", model=net.state_dict(),
                 opt=st).save("m", it=1)
    zeros = lambda d: {k: torch.zeros_like(v) for k, v in d.items()}
    ck = CheckpointIO(str(tmp_path), backend="orbax",
                      model=zeros(net.state_dict()),
                      opt=AdamState(0, zeros(st.mu), zeros(st.nu)))
    ck.load("m")
    got = ck.registry["opt"]
    assert isinstance(got, AdamState) and got.count == 1 and isinstance(got.count, int)
    for k in st.mu:
        assert torch.equal(got.mu[k], st.mu[k]) and torch.equal(got.nu[k], st.nu[k])
        assert float(got.mu[k].abs().max()) > 0 and float(got.nu[k].abs().max()) > 0
    for k, v in net.state_dict().items():
        assert torch.equal(ck.registry["model"][k], v)
    # JAX's backend on the same moments: optax's ScaleByAdamState
    jp = {k: jnp.asarray(v.detach().numpy()) for k, v in net.state_dict().items()}
    ost = optax.adam(1e-3, b2=0.99).init(jp)
    ost = (ost[0]._replace(count=jnp.asarray(1, jnp.int32),
                           mu={k: jnp.asarray(v.numpy()) for k, v in st.mu.items()},
                           nu={k: jnp.asarray(v.numpy()) for k, v in st.nu.items()}),
           ) + tuple(ost[1:])
    JCheckpointIO(str(tmp_path / "jax"), backend="orbax", opt=ost).save("m", it=1)
    jck = JCheckpointIO(str(tmp_path / "jax"), backend="orbax",
                        opt=jax.tree.map(jnp.zeros_like, ost))
    jck.load("m")
    jst = jck.registry["opt"][0]
    assert int(jst.count) == got.count
    for k in st.mu:
        np.testing.assert_array_equal(np.asarray(jst.mu[k]), got.mu[k].numpy())
        np.testing.assert_array_equal(np.asarray(jst.nu[k]), got.nu[k].numpy())


def test_orbax_backend_under_two_gloo_ranks(tmp_path):
    from torch.distributed.checkpoint import FileSystemReader

    net, st = _adam_step()
    inp = {"dir": str(tmp_path / "ck"), "it": 9, "count": st.count,
           "w": np.arange(6, dtype=np.float32),
           "rows": np.arange(16, dtype=np.float32).reshape(8, 2)}
    inp.update({f"mu:{k}": v.numpy() for k, v in st.mu.items()})
    inp.update({f"nu:{k}": v.numpy() for k, v in st.nu.items()})
    r0, r1 = spawn("checkpoint", inp, tmp_path, timeout=180)
    for r, rows in ((r0, inp["rows"][:4]), (r1, inp["rows"][4:])):
        assert str(r["path"]) == str(tmp_path / "ck" / "model.orbax")
        assert int(r["it"]) == 9 and int(r["count"]) == st.count
        np.testing.assert_array_equal(r["w"], inp["w"])
        np.testing.assert_array_equal(r["rows_local"], rows)
        for k in st.mu:
            np.testing.assert_array_equal(r[f"mu:{k}"], inp[f"mu:{k}"])
            np.testing.assert_array_equal(r[f"nu:{k}"], inp[f"nu:{k}"])
    # where each entry's bytes went: one file for a replicated entry, the
    # two ranks' files for the sharded one
    md = FileSystemReader(str(tmp_path / "ck" / "model.orbax")).read_metadata()
    files = {}
    for idx, info in md.storage_data.items():
        files.setdefault(idx.fqn, set()).add(info.relative_path)
    assert len(files["rows:"]) == 2
    assert all(len(f) == 1 for k, f in files.items() if k != "rows:")
    assert {k for k in files} >= {"model:w", "opt:count", "scalar:it"}
