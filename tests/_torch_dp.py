"""Rank bodies of the port's data-parallel CPU tests, run as
``python -m tests._torch_dp <what> <spec file> <output dir>`` by
``flair_for_aigle_tpu_torch/tools/dryrun_multichip.py run_ranks`` (gloo,
one thread a rank). Imports no jax: the ranks run the port alone.

``one_step(spec, rank, world)`` is also the one-process reference that the
tests compute in their own process with ``rank, world = 0, 1``.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from flair_for_aigle_tpu_torch.models.flair_model import FlairHubModel
from flair_for_aigle_tpu_torch.parallel import dist
from flair_for_aigle_tpu_torch.parallel.mesh import ShardedGenerator, shard_batch
from flair_for_aigle_tpu_torch.train.optim import make_optimizer
from flair_for_aigle_tpu_torch.train.task import make_steps
from flair_for_aigle_tpu_torch.train.trainer import step_seed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one_step(spec: dict, rank: int, world: int) -> dict:
    """One AdamW step of the port from ``spec`` ({config, batch: the global
    batch, state_dict, lr, step}) on shard ``rank`` of ``world``: the loss,
    the gradients by parameter name and the confusion matrix (all summed
    over the group), and the state dict after the step."""
    cfg = spec["config"]
    model = FlairHubModel(cfg)
    model.load_state_dict(spec["state_dict"], strict=True)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    optimizer = make_optimizer(cfg["hyperparams"], [p for p in model.parameters()
                                                    if p.requires_grad])
    gen = ShardedGenerator("cpu", rank, world)
    steps = make_steps(model, cfg, optimizer, "cpu", generator=gen)
    gen.manual_seed(step_seed(cfg["hyperparams"]["seed"], spec["step"]))
    loss, grads, preds, targets = steps.loss_and_grads(shard_batch(spec["batch"], rank, world))
    optimizer.step(grads, spec["lr"])
    return {"loss": float(loss), "grads": dict(zip(names, grads)),
            "confmats": {t: cm.numpy() for t, cm in steps.confmats(preds, targets).items()},
            "state": {k: v.detach().clone() for k, v in model.state_dict().items()}}


def collectives(rank: int, world: int, out_dir: str) -> None:
    """The group helpers of ``parallel/dist.py`` on two ranks."""
    from flair_for_aigle_tpu_torch.writer.prediction_writer import PredictionWriter

    assert dist.world_size() == world and dist.process_index() == rank
    assert dist.is_rank_zero() == (rank == 0)
    # shard-local confusion matrices, rank r contributes r + 1 everywhere;
    # the writer sums them and only rank 0 writes the metrics
    config = {"labels": ["T"], "labels_configs": {"T": {"value_name": ["a", "b", "c"]}},
              "paths": {"out_model_name": "m"}, "tasks": {"write_files": False},
              "modalities": {"inputs": {}}}
    writer = PredictionWriter(config, output_dir=out_dir)
    writer.accumulated_confmats["T"] = np.full((3, 3), rank + 1, np.int64)
    writer.on_predict_epoch_end()
    assert (writer.accumulated_confmats["T"] == 3).all(), writer.accumulated_confmats["T"]
    assert (dist.all_sum_host(np.array([0.5 * (rank + 1)])) == 1.5).all()
    # AllReduceSum: y is the sum over the ranks; rank r's loss is (r + 1) y,
    # so every x's gradient is the sum of the ranks' factors, 3
    x = torch.tensor([rank + 1.0, 2.0 * (rank + 1)], requires_grad=True)
    y = dist.AllReduceSum.apply(x)
    assert y.tolist() == [3.0, 6.0], y
    ((rank + 1.0) * y).sum().backward()
    assert x.grad.tolist() == [3.0, 3.0], x.grad
    # the gradient sum keeps None in place; sum_over_group leaves no graph
    g = dist.all_reduce_grads([torch.full((2, 2), rank + 1.0), None, torch.ones(3)])
    assert g[0].tolist() == [[3.0, 3.0], [3.0, 3.0]] and g[1] is None
    assert g[2].tolist() == [2.0, 2.0, 2.0]
    s = dist.sum_over_group(torch.tensor(rank + 1.0, requires_grad=True))
    assert float(s) == 3.0 and not s.requires_grad
    # every parameter and buffer becomes rank 0's
    m = torch.nn.BatchNorm1d(4)
    with torch.no_grad():
        m.weight.fill_(rank + 1.0)
        m.running_mean.fill_(rank + 2.0)
    dist.broadcast_module(m)
    assert (m.weight == 1.0).all() and (m.running_mean == 2.0).all()
    dist.barrier()


def main(argv) -> None:
    what, spec_path, out_dir = argv
    torch.set_num_threads(1)
    dist.initialize(device="cpu")
    rank, world = dist.process_index(), dist.world_size()
    if what == "collectives":
        collectives(rank, world, out_dir)
    elif what == "train_step":
        spec = torch.load(spec_path, weights_only=False)
        torch.save(one_step(spec, rank, world), os.path.join(out_dir, f"rank{rank}.pt"))
    else:
        raise ValueError(what)
    torch.distributed.destroy_process_group()
    print(f"RANK_OK {rank}", flush=True)


def run(what: str, spec_path: str, out_dir: str, world: int = 2,
        timeout: float = 300.0) -> list[str]:
    """Run ``what`` on ``world`` gloo ranks; their outputs."""
    from flair_for_aigle_tpu_torch.tools.dryrun_multichip import run_ranks

    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    outs = run_ranks(lambda r: [sys.executable, "-m", "tests._torch_dp", what,
                                str(spec_path), str(out_dir)], world, timeout, env)
    for r, out in enumerate(outs):
        assert f"RANK_OK {r}" in out, out
    return outs


if __name__ == "__main__":
    main(sys.argv[1:])
