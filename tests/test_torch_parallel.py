"""The port's data-parallel helpers (``parallel/mesh.py``,
``parallel/dist.py``) on the CPU.

* ``make_mesh``, ``shard_batch`` and ``pad_batch_to`` against the JAX
  package's ``parallel/mesh.py`` on the same arrays (the conftest's virtual
  CPU devices): the same dp size, each device's shard, the same padding.
* The deliberate divergences raise: a batch that does not split into equal
  shards, more CUDA devices than exist.
* ``ShardedGenerator``: the shards' masks and noise, put together, are the
  one-process draws.
* On two gloo ranks (``tests/_torch_dp.py collectives``): ``all_sum_host``
  through the PredictionWriter with rank-0 gating (port of
  ``tests/test_dist_multiprocess.py:57-80``), ``AllReduceSum``'s gradient,
  the gradient sum, ``sum_over_group``, ``broadcast_module``, ``barrier``.
* A single process joins no group.
* The launch check refuses a tensor off the current CUDA device (a
  stand-in tensor and a mocked current device), and every function that
  launches a kernel makes it.
"""

import inspect
import sys

import jax
import numpy as np
import pytest
import torch

from flair_for_aigle_tpu.parallel import mesh as jmesh
from flair_for_aigle_tpu_torch.models.layers import dropout, xavier_uniform_like
from flair_for_aigle_tpu_torch.ops import _build
from flair_for_aigle_tpu_torch.parallel import dist, mesh
from flair_for_aigle_tpu_torch.tools.dryrun_multichip import run_ranks
from tests import _torch_dp


def _batch(b=8):
    rng = np.random.default_rng(0)
    return {"x": rng.normal(size=(b, 3, 4, 4)).astype(np.float32),
            "y": rng.integers(0, 5, (b, 4, 4)).astype(np.int32),
            "id": "not an array"}


@pytest.mark.parametrize("dp", [1, 2, 4, 8])
def test_shard_batch_matches_the_jax_layout(dp):
    jm = jmesh.make_mesh(n_devices=dp)
    pm = mesh.make_mesh(dp, device_type="cpu")
    assert pm.dp == jm.shape["dp"] == dp
    batch = _batch()
    sharded = jmesh.shard_batch(jm, {k: v for k, v in batch.items() if k != "id"})
    for i, dev in enumerate(jm.devices.reshape(-1)):
        ours = mesh.shard_batch(batch, i, dp)
        assert ours["id"] == "not an array"
        for k in ("x", "y"):
            want = next(s.data for s in sharded[k].addressable_shards if s.device == dev)
            np.testing.assert_array_equal(ours[k], np.asarray(want))


@pytest.mark.parametrize("size", [5, 8])
def test_pad_batch_to_matches_jax(size):
    batch = {k: v[:5] if k != "id" else v for k, v in _batch().items()}
    want, valid = jmesh.pad_batch_to(batch, size)
    got = mesh.pad_batch_to(batch, size)
    assert valid == 5 and got.keys() == want.keys()
    for k in ("x", "y"):
        np.testing.assert_array_equal(got[k], want[k])


def test_shard_batch_of_torch_tensors_and_an_uneven_batch():
    t = torch.arange(12).reshape(6, 2)
    assert mesh.shard_batch({"t": t}, 2, 3)["t"].tolist() == [[8, 9], [10, 11]]
    with pytest.raises(ValueError, match="does not split into 4 equal shards"):
        mesh.shard_batch({"t": t}, 0, 4)
    with pytest.raises(ValueError, match="outside a mesh"):
        mesh.shard_batch({"t": t}, 3, 3)


def test_make_mesh_raises_where_jax_shrinks(monkeypatch):
    """The JAX ``make_mesh`` gives ``devices[:n]``, a smaller mesh, when
    fewer devices exist; the port raises."""
    assert len(jmesh.make_mesh(n_devices=64).devices.reshape(-1)) == len(jax.devices())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh.make_mesh(2).devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    with pytest.raises(RuntimeError, match="3 CUDA device"):
        mesh.make_mesh(3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="1 CUDA device"):
        mesh.make_mesh(1)
    # an explicit list may repeat a device
    assert mesh.make_mesh(devices=["cpu", "cpu"]).dp == 2


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_draws_are_the_one_process_draws(world):
    x = torch.ones(8, 6, 5, 3)

    def draws(index, count):
        gen = mesh.ShardedGenerator("cpu", index, count)
        gen.manual_seed(11)
        part = x[index * 8 // count:(index + 1) * 8 // count]
        return (dropout(part, 0.3, True, gen), dropout(part, 0.5, True, gen, channel_wise=True),
                xavier_uniform_like(part, gen))

    whole = draws(0, 1)
    shards = [draws(i, world) for i in range(world)]
    for k in range(3):
        torch.testing.assert_close(torch.cat([s[k] for s in shards]), whole[k],
                                   rtol=0, atol=0)
    # a plain generator draws as a ShardedGenerator of one shard
    gen = torch.Generator().manual_seed(11)
    torch.testing.assert_close(dropout(x, 0.3, True, gen), whole[0], rtol=0, atol=0)


def test_single_process_joins_no_group(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert dist.initialize(device="cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    assert dist.world_size() == 1 and dist.process_index() == 0
    g = (torch.ones(2), None)
    assert dist.all_reduce_grads(g) == g
    t = torch.ones(2)
    assert dist.sum_over_group(t) is t


def test_two_rank_collectives(tmp_path):
    _torch_dp.run("collectives", "-", str(tmp_path))
    assert (tmp_path / "metrics_m" / "T" / "metrics.json").exists()


def test_a_failing_rank_fails_the_run():
    with pytest.raises(RuntimeError, match="rank 1 exited with 3"):
        run_ranks(lambda r: [sys.executable, "-c", f"import sys; sys.exit({3 * r})"], 2, 60)
    with pytest.raises(RuntimeError, match="outlasted"):
        run_ranks(lambda r: [sys.executable, "-c", "import time; time.sleep(60)"], 2, 1)


class _OnCard:
    """A stand-in for a tensor on a CUDA device."""

    def __init__(self, index):
        self.device = torch.device("cuda", index)


def test_launch_refuses_a_tensor_off_the_current_device(monkeypatch):
    class Stream:
        cuda_stream = 1234

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    assert _build.stream_ptr(_OnCard(0)) == 1234
    with pytest.raises(RuntimeError, match=r"cuda:1 while cuda:0 is the current device"):
        _build.stream_ptr(_OnCard(1))


def test_every_launching_function_checks_the_device():
    from flair_for_aigle_tpu_torch.ops import (
        attn_dots, epilogue, ffn, finish, merge, prep, window_attn)

    launching = []
    for module in (attn_dots, epilogue, ffn, finish, merge, prep, window_attn):
        for name, fn in inspect.getmembers(module, inspect.isfunction):
            src = inspect.getsource(fn)
            if fn.__module__ == module.__name__ and "launches += 1" in src:
                launching.append(name)
                assert "_build.stream_ptr(" in src, name
    assert len(launching) == 12, launching
