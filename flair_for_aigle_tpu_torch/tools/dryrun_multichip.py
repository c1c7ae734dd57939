"""Data-parallel dry run of the port (port of ``__graft_entry__.py
dryrun_multichip``): one training step and one eval step of the full
multimodal model over W ranks of ``torch.distributed``.

    python -m flair_for_aigle_tpu_torch.tools.dryrun_multichip \\
        [--world 2] [--device cpu|cuda] [--backend gloo|nccl] [--timeout 600]

The model is the JAX dry run's: swin-tiny-UPerNet on AERIAL_RGBI fused
with a SENTINEL2_TS UTAE, 7 classes, 64 px, T = 3, random weights from the
configuration's seed; the global batch holds 2 W samples and each rank
takes its contiguous 2 (``parallel/mesh.py shard_batch``). The step runs
the port's kernels on every rank (``--device cuda``; rank r on card r mod
the cards present, so two gloo ranks share one card) or their plain
versions (``--device cpu``, gloo). Every rank checks a finite loss and an
eval confusion matrix summed over the ranks to 2 W x 64 x 64 pixels; rank
0 prints ``dryrun_multichip(W) ok: loss=...``. The kernels are built in
this process before any rank starts. A rank that fails, or a run that
outlasts ``--timeout``, ends every rank and exits non-zero.
"""

from __future__ import annotations

import argparse
import math
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Callable, Sequence

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ARCH = "swin_tiny_patch4_window7_224-upernet"
TASK = "AERIAL_LABEL-COSIA"
N_CLASSES, SIZE, T_STEPS = 7, 64, 3


def config() -> dict:
    """The JAX dry run's configuration (``__graft_entry__.py
    _flagship_config`` with SENTINEL2_TS on: ``tests/_fixtures.py
    make_config``'s schema and values)."""
    inputs = {m: m in ("AERIAL_RGBI", "SENTINEL2_TS") for m in (
        "AERIAL_RGBI", "AERIAL-RLT_PAN", "DEM_ELEV", "SPOT_RGBI",
        "SENTINEL2_TS", "SENTINEL1-ASC_TS", "SENTINEL1-DESC_TS")}
    return {
        "modalities": {
            "inputs": inputs,
            "inputs_channels": {"AERIAL_RGBI": [1, 2, 3], "SPOT_RGBI": [1, 2, 3, 4],
                                "SENTINEL2_TS": [1, 2, 3], "SENTINEL1-ASC_TS": [1, 2],
                                "SENTINEL1-DESC_TS": [1, 2]},
            "aux_loss": {m: False for m in inputs},
            "aux_loss_weight": 1.5,
            "modality_dropout": {m: 0 for m in inputs},
            "pre_processings": {"use_augmentation": False},
        },
        "models": {
            "monotemp_model": {"arch": ARCH, "new_channels_init_mode": "random"},
            "multitemp_model": {
                "ref_date": "05-15", "encoder_widths": [16, 16, 32],
                "decoder_widths": [8, 16, 32], "out_conv": [8, 19],
                "str_conv_k": 3, "str_conv_s": 1, "str_conv_p": 1,
                "agg_mode": "att_group", "encoder_norm": "group",
                "n_head": 4, "d_model": 32, "d_k": 4,
                "pad_value": 0, "padding_mode": "reflect",
            },
        },
        "labels": [TASK],
        "labels_configs": {TASK: {
            "task_weight": 1.0, "value_name": {i: f"c{i}" for i in range(N_CLASSES)},
            "value_weights": {"default": 1, "default_exceptions": {},
                              "per_modality_exceptions": {}}}},
        "paths": {"ckpt_model_path": ""},
        "hyperparams": {
            "num_epochs": 2, "batch_size": 2, "seed": 2025,
            "learning_rate": 5e-5, "optimizer": "adamw",
            "optim_weight_decay": 0.01, "optim_betas": [0.9, 0.999],
            "scheduler": "one_cycle_lr", "warmup_fraction": 0.2,
            "plateau_patience": 10,
        },
    }


def global_batch(world: int) -> dict:
    """The JAX dry run's batch of 2 W samples (its seed and draws)."""
    n = 2 * world
    rng = np.random.default_rng(0)
    return {
        "AERIAL_RGBI": rng.normal(size=(n, 3, SIZE, SIZE)).astype(np.float32),
        "SENTINEL2_TS": rng.normal(size=(n, T_STEPS, 3, SIZE, SIZE)).astype(np.float32),
        "SENTINEL2_DATES": np.sort(rng.integers(-180, 180, (n, T_STEPS))).astype(np.float32),
        TASK: np.eye(N_CLASSES, dtype=np.float32)[
            rng.integers(0, N_CLASSES, (n, SIZE, SIZE))].transpose(0, 3, 1, 2),
    }


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(command: Callable[[int], Sequence[str]], world: int, timeout: float,
              env: dict | None = None) -> list[str]:
    """Start ``command(rank)`` for every rank as a process with torchrun's
    environment (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT`` of a free local port) and wait for all of them. Returns
    their outputs (stdout and stderr) in rank order. Raises, after ending
    every rank still running, when a rank exits non-zero or the ranks
    outlast ``timeout`` seconds."""
    base = dict(os.environ if env is None else env)
    base.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), WORLD_SIZE=str(world))
    logs = [tempfile.TemporaryFile("w+") for _ in range(world)]
    procs = [subprocess.Popen(list(command(r)), stdout=logs[r], stderr=subprocess.STDOUT,
                              text=True, env={**base, "RANK": str(r), "LOCAL_RANK": str(r)})
             for r in range(world)]
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
                break
            if time.monotonic() > deadline:
                failed = f"the ranks outlasted {timeout:.0f} s"
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed or bad:
        raise RuntimeError((failed or f"rank {bad[0]} exited with {procs[bad[0]].returncode}")
                           + "".join(f"\n--- rank {r} ---\n{outs[r][-4000:]}" for r in bad))
    return outs


def rank_device(rank: int, device: str) -> str:
    if device == "cpu":
        return "cpu"
    return f"cuda:{rank % torch.cuda.device_count()}"


def rank_main(device: str, backend: str | None) -> str:
    """One rank of the dry run (torchrun's environment); returns rank 0's
    line."""
    from flair_for_aigle_tpu_torch.parallel import dist
    from flair_for_aigle_tpu_torch.parallel.mesh import ShardedGenerator, shard_batch
    from flair_for_aigle_tpu_torch.train.optim import make_optimizer
    from flair_for_aigle_tpu_torch.train.stages import build_model
    from flair_for_aigle_tpu_torch.train.task import make_steps

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device == "cpu":
        torch.set_num_threads(1)
    dev = dist.initialize(device=rank_device(rank, device), backend=backend)
    cfg = config()
    model = build_model(cfg).to(dev)
    dist.broadcast_module(model)
    optimizer = make_optimizer(cfg["hyperparams"], list(model.parameters()))
    gen = ShardedGenerator(dev, rank, world)
    gen.manual_seed(1)
    steps = make_steps(model, cfg, optimizer, dev, generator=gen)
    shard = shard_batch(global_batch(world), rank, world)
    loss = float(steps.train_step(shard, cfg["hyperparams"]["learning_rate"])["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite loss: {loss}")
    total = int(steps.eval_step(shard)["confmats"][TASK].sum())
    if total != 2 * world * SIZE * SIZE:
        raise AssertionError(f"eval confusion matrix sums to {total}, "
                             f"not {2 * world * SIZE * SIZE}")
    torch.distributed.destroy_process_group()
    return f"dryrun_multichip({world}) ok: loss={loss:.4f}"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--world", type=int, default=2, help="ranks (W)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                        help="default: nccl with --device cuda, gloo with --device cpu")
    parser.add_argument("--timeout", type=float, default=600.0, help="seconds for all ranks")
    parser.add_argument("--rank-main", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank_main:
        line = rank_main(args.device, args.backend)
        if int(os.environ["RANK"]) == 0:
            print(line, flush=True)
        return 0
    if args.device == "cuda":
        from flair_for_aigle_tpu_torch.device import resolve_device
        from flair_for_aigle_tpu_torch.ops import _build

        resolve_device("cuda")
        if args.backend != "gloo" and args.world > torch.cuda.device_count():
            raise SystemExit(f"--world {args.world} over NCCL needs as many cards; "
                             f"{torch.cuda.device_count()} present (gloo shares cards)")
        _build.lib()  # build once here, not in every rank
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    outs = run_ranks(lambda r: [sys.executable, "-m", "flair_for_aigle_tpu_torch.tools."
                                "dryrun_multichip", "--rank-main", "--device", args.device,
                                *(["--backend", args.backend] if args.backend else [])],
                     args.world, args.timeout, env)
    ok = [ln for ln in outs[0].splitlines() if ln.startswith("dryrun_multichip(")]
    if not ok:
        raise RuntimeError(f"rank 0 printed no result:\n{outs[0][-4000:]}")
    print(ok[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
