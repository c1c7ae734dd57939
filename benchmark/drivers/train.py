"""Training traffic: a closed loop of the port's ``Steps.train_step``
(``train/task.py``): the host batch copied to the card by the step itself,
the forward, the weighted cross-entropy, the backward and AdamW, each step
ended by a synchronise.

Batches are laid out as the data module lays them out: normalised float32
images (standard normal) and float32 one-hot labels of uniform random
classes, ``batch_size`` rows at ``px`` pixels, a pool of ``pool`` batches
made from the seed in set-up (on the device, then copied to the host). The
learning rate follows the recipe's one-cycle schedule over
``schedule_steps`` steps.

Set-up builds one model, optimizer and step object and drives it through
the first ``check_steps`` steps on distinct batches; the window goes on
with the same object. Correctness: once the window has closed and the
program is freed, the plain float32 reference (TF32 off) runs the same
first steps from the same weights and batches; compared are each step's
loss, every leaf's gradient norm of the first step (the port's from its
AdamW first moment) and every leaf's change after the last.
"""

from __future__ import annotations

import copy
import gc
import statistics
import time

import torch
import torch.nn.functional as F

from benchmark import registry, weights
from benchmark.context import Context, process_age_s
from benchmark.frozen import raster
from benchmark.profiling import sync, trace_units, unit_quartiles
from benchmark.reference import precision
from benchmark.reference import train as tref


def train_config(ctx: Context) -> dict:
    cfg = copy.deepcopy(ctx.config["train"])
    cfg["models"]["monotemp_model"]["arch"] = ctx.config["arch"]
    cfg["hyperparams"]["compute_dtype"] = ctx.traffic["compute_dtype"]
    return cfg


def modality_and_task(cfg: dict) -> tuple[str, str]:
    mods = [m for m, on in cfg["modalities"]["inputs"].items() if on]
    if len(mods) != 1 or len(cfg["labels"]) != 1:
        raise ValueError("the training driver runs one modality and one task")
    return mods[0], cfg["labels"][0]


def batch_pool(ctx: Context, cin: int, classes: int, mod: str, task: str) -> list[dict]:
    tr = ctx.traffic
    g = raster.generator(ctx.seed, ctx.device, stream=3)
    shape = (tr["pool"], tr["batch_size"])
    px = tr["px"]
    imgs = torch.randn(shape + (cin, px, px), generator=g, device=ctx.device)
    cls = torch.randint(0, classes, shape + (px, px), generator=g, device=ctx.device)
    onehot = F.one_hot(cls, classes).permute(0, 1, 4, 2, 3).float()
    imgs_h, onehot_h = imgs.cpu().numpy(), onehot.cpu().numpy()
    del imgs, cls, onehot
    return [{mod: imgs_h[p], task: onehot_h[p]} for p in range(tr["pool"])]


def schedule(ctx: Context, cfg: dict):
    hp = cfg["hyperparams"]
    return tref.one_cycle_lr(hp["learning_rate"], ctx.traffic["schedule_steps"],
                             pct_start=hp["warmup_fraction"])


def leaf_gaps(port: dict, ref: dict, names: list[str]) -> list[float]:
    """|port norm - reference norm| of each leaf over the larger of the
    reference's norm of that leaf and of the median leaf."""
    med = statistics.median(ref[n] for n in names)
    return [abs(port[n] - ref[n]) / max(ref[n], med) for n in names]


def run(ctx: Context) -> None:
    tr = ctx.traffic
    cfg = train_config(ctx)
    fam = registry.family(ctx.config["family"])
    mod, task = modality_and_task(cfg)
    cin = len(cfg["modalities"]["inputs_channels"][mod])
    classes = len(cfg["labels_configs"][task]["value_name"])
    tf32 = bool(ctx.config["train_tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32

    from flair_for_aigle_tpu_torch.models.flair_model import FlairHubModel
    from flair_for_aigle_tpu_torch.train.optim import make_optimizer
    from flair_for_aigle_tpu_torch.train.task import make_steps

    ctx.info["setup_ages_s"] = {"driver": process_age_s()}
    batches = batch_pool(ctx, cin, classes, mod, task)
    ctx.info["setup_ages_s"]["batches"] = process_age_s()
    with torch.device(ctx.device):
        model = FlairHubModel(cfg)
    spec = weights.reference_layout(fam, ctx.config, cin, ctx.device)
    state = weights.make(spec, ctx.seed, ctx.device)
    model.load_state_dict(weights.port_state(state, mod, task), strict=True)
    del state
    model.to(ctx.device)
    ref_names = {weights.port_name(k, mod, task): k for k in spec}
    names = [ref_names[n] for n, _ in model.named_parameters()]
    opt = make_optimizer(cfg["hyperparams"], model.parameters())
    steps = make_steps(model, cfg, opt, ctx.device)
    lr = schedule(ctx, cfg)
    b1 = cfg["hyperparams"]["optim_betas"][0]
    ctx.info["setup_ages_s"]["model"] = process_age_s()

    # set-up: the first steps through the window's own call, read for the check
    n_check = tr["check_steps"]
    p0 = [p.detach().clone() for p in steps.params]
    losses = []
    for k in range(n_check):
        out = steps.train_step(batches[k % len(batches)], lr(k))
        losses.append(float(out["loss"]))
        if k == 0:
            grad = [float(v) / (1 - b1) for v in torch._foreach_norm(opt.mu)]
    change = [float(v) for v in torch._foreach_norm(
        torch._foreach_sub([p.detach() for p in steps.params], p0))]
    del p0
    sync(ctx)
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)

    def run_unit(k: int) -> dict:
        t0 = time.perf_counter()
        steps.train_step(batches[k % len(batches)], lr(k))
        sync(ctx)
        return {"start": t0, "end": time.perf_counter(), "step": k}

    gc.collect()
    gc.freeze()  # set-up's objects are not scanned again in the window
    t_w0 = time.perf_counter()
    ctx.setup_s = process_age_s()
    k = n_check
    while True:
        ctx.units.append(run_unit(k))
        k += 1
        if time.perf_counter() - t_w0 >= ctx.seconds:
            break
    ctx.window_s = ctx.units[-1]["end"] - t_w0
    if ctx.trace:
        ctx.traced_units, ctx.summary = trace_units(ctx, run_unit, tr["trace_steps"], k)
    if ctx.device.type == "cuda":
        ctx.peak_mem_bytes = torch.cuda.max_memory_allocated(ctx.device)

    px, bsz = tr["px"], tr["batch_size"]
    ctx.per_unit = {"samples": bsz, "batches": 1, "batch_size": bsz}
    ctx.flops_per_unit = 3 * bsz * fam.forward_flops(ctx.config, px, cin)
    ctx.precision = "bf16" if tr["compute_dtype"] == "bfloat16" else "tf32"
    ctx.elem_bytes = 2 if tr["compute_dtype"] == "bfloat16" else 4
    ctx.port_kernels = list(ctx.config["kernels"]["train"])
    ctx.geo = {"stages": fam.stages(ctx.config, px), "px": px,
               "mlp_ratio": ctx.config["encoder"].get("mlp_ratio", 4)}
    ctx.info["steps"] = len(ctx.units)
    ctx.info["step_s_quartiles"] = unit_quartiles(ctx.units)

    port = {"loss": losses, "grad": dict(zip(names, grad)), "change": dict(zip(names, change))}
    del steps, opt, model
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    check(ctx, cfg, fam, cin, mod, task, batches, lr, port)


def reference_steps(ctx: Context, cfg: dict, fam, cin: int, mod: str, task: str,
                    batches: list, lr, count: int, loss_fn=None) -> dict:
    """The plain reference's first ``count`` steps: each loss, each leaf's
    gradient norm of the first step, each leaf's change after the last."""
    hp = cfg["hyperparams"]
    with torch.device(ctx.device):
        ref = fam.build(ctx.config, cin)
    ref.load_state_dict(weights.make(weights.layout(ref), ctx.seed, ctx.device), strict=True)
    ref.encoder.model.checkpoint = True
    ref.train()
    params = dict(ref.named_parameters())
    p0 = {k: p.detach().clone() for k, p in params.items()}
    adam = tref.AdamW(params, hp["optim_betas"][0], hp["optim_betas"][1],
                      hp["optim_weight_decay"])
    vw = cfg["labels_configs"][task]["value_weights"]
    w = torch.tensor(tref.class_weights({"classes": len(cfg["labels_configs"][task]["value_name"]),
                                         "default": vw["default"],
                                         "exceptions": vw.get("default_exceptions")}),
                     device=ctx.device)
    loss_fn = loss_fn or tref.weighted_cross_entropy
    losses, grad = [], {}
    for k in range(count):
        b = batches[k % len(batches)]
        x = torch.from_numpy(b[mod]).to(ctx.device)
        y = torch.from_numpy(b[task]).to(ctx.device)
        loss = loss_fn(ref(x), y, w)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        losses.append(float(loss.detach()))
        if k == 0:
            grad = {n: (0.0 if g is None else float(g.norm())) for n, g in zip(params, grads)}
        adam.step(dict(zip(params, grads)), lr(k))
        del grads, loss, x, y
    change = {n: float((p.detach() - p0[n]).norm()) for n, p in params.items()}
    return {"loss": losses, "grad": grad, "change": change}


def compare(port: dict, ref: dict) -> dict:
    """The numbers that decide ``correct``: the worst step's relative loss
    gap, the worst leaf's gradient-norm gap and the worst leaf's change gap
    (the latter over the leaves whose reference gradient is at least a
    thousandth of the median leaf's)."""
    names = list(ref["grad"])
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(port["loss"], ref["loss"]))
    med = statistics.median(ref["grad"][n] for n in names)
    moved = [n for n in names if ref["grad"][n] >= 1e-3 * med]
    grad = leaf_gaps(port["grad"], ref["grad"], names)
    change = leaf_gaps(port["change"], ref["change"], moved)
    return {"loss_gap": loss_gap, "grad_norm_gap": max(grad), "update_norm_gap": max(change),
            "leaves": len(names), "leaves_moved": len(moved),
            "worst_grad_leaf": names[grad.index(max(grad))],
            "worst_update_leaf": moved[change.index(max(change))]}


def check(ctx: Context, cfg: dict, fam, cin: int, mod: str, task: str, batches, lr,
          port: dict) -> None:
    t0 = time.perf_counter()
    with precision.tf32(False):
        ref = reference_steps(ctx, cfg, fam, cin, mod, task, batches, lr,
                              ctx.traffic["check_steps"])
    got = compare(port, ref)
    for name in ("loss_gap", "grad_norm_gap", "update_norm_gap"):
        ctx.add_check(name, got[name], ctx.limits[name])
    ctx.info.update(leaves=got["leaves"], leaves_moved=got["leaves_moved"],
                    worst_grad_leaf=got["worst_grad_leaf"],
                    worst_update_leaf=got["worst_update_leaf"],
                    losses=port["loss"], reference_losses=ref["loss"],
                    check_s=time.perf_counter() - t0)
