"""The port's FlairHubModel against the torch oracle of the reference
layout (``tests/torch_refs.py TFlairHubModel``): the flagship fusion case
4 (Swin + Sentinel-2 UTAE, full fusion, UPerNet decoder, aux heads on both
modalities) at the micro geometry of ``tests/test_multimodal_golden.py``.

* The oracle's state dict loads into the port with ``strict=True`` and no
  renames. Only its BatchNorm ``num_batches_tracked`` counters are left out:
  the port's BatchNorm keeps none, as the JAX converter ignores them.
  ``inconv``'s kernel-1 Conv1d weight (out, in, 1) loads as the Linear it
  is.
* The port's task and aux logits match the oracle's under that test's
  ``assert_logits_match`` bounds.
* The port's stage outputs (Swin pyramid, UTAE logits and maps, fused
  pyramid, task decoder) match the pinned ``micro`` fingerprints of
  ``tests/golden/multimodal_fingerprints.json`` within its rtol 5e-4.
* ``load_checkpoint`` loads the oracle's state dict from a safetensors file
  with every key of the port covered and none unused.
"""

import numpy as np
import torch
from safetensors.torch import save_file

from flair_for_aigle_tpu_torch.models.checkpoint import load_checkpoint
from flair_for_aigle_tpu_torch.models.flair_model import FlairHubModel
from tests._fixtures import make_config
from tests.test_multimodal_golden import (
    CAPTURE,
    MICRO_KW,
    TASK,
    assert_logits_match,
    check_fingerprints,
)
from tests.torch_refs import TFlairHubModel

N_CLASSES, IMG, S2, T_STEPS = 7, 128, 8, 3


def _oracle_and_batch(seed=0):
    """The oracle and batch of ``test_multimodal_golden.build_pair`` (same
    seeds, same draws, in the same order)."""
    torch.manual_seed(seed)
    oracle = TFlairHubModel(tasks=(TASK,), nclasses=(N_CLASSES,),
                            **MICRO_KW["oracle_kw"]).eval()
    rng = np.random.default_rng(seed)
    batch = {
        "AERIAL_RGBI": rng.normal(size=(1, 3, IMG, IMG)).astype(np.float32),
        "SENTINEL2_TS": rng.normal(size=(1, T_STEPS, 3, S2, S2)).astype(np.float32),
        "SENTINEL2_DATES": np.sort(rng.integers(-180, 180, (1, T_STEPS))).astype(np.float32),
        TASK: np.zeros((1, N_CLASSES, IMG, IMG), np.float32),
    }
    return oracle, batch


def _config():
    return make_config(arch=MICRO_KW["arch"], mono=("AERIAL_RGBI",),
                       multi=("SENTINEL2_TS",), tasks=((TASK, N_CLASSES),),
                       aux=("AERIAL_RGBI", "SENTINEL2_TS"))


def _oracle_state_dict(oracle):
    return {k: v for k, v in oracle.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def test_port_loads_the_oracle_strictly_and_matches_its_logits_and_fingerprints():
    oracle, batch_np = _oracle_and_batch()
    model = FlairHubModel(_config()).eval()
    sd = _oracle_state_dict(oracle)
    assert sd["encoders.SENTINEL2_TS.temporal_encoder.inconv.weight"].ndim == 3
    model.load_state_dict(sd, strict=True)

    captured = {}
    for name in CAPTURE:
        model.get_submodule(name).register_forward_hook(
            lambda mod, args, out, name=name: captured.__setitem__(name, out))
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    with torch.no_grad():
        want_tasks, want_aux = oracle(batch)
        got_tasks, got_aux = model(batch)
    assert set(got_tasks) == set(want_tasks) and set(got_aux) == set(want_aux)
    for got, want in ((got_tasks, want_tasks), (got_aux, want_aux)):
        for k in want:
            assert_logits_match(got[k].numpy(), want[k].numpy())

    def leaves(out):
        if isinstance(out, (list, tuple)):
            return [a for o in out for a in leaves(o)]
        return [out]

    fps = {}
    for name, out in captured.items():
        arrays = [a.double().numpy() for a in leaves(out) if a.numel()]
        fps[name] = [[float(a.mean()), float(a.std()), float(np.abs(a).max())]
                     for a in arrays]
    check_fingerprints(fps, "micro")


def test_load_checkpoint_covers_the_oracle_layout(tmp_path):
    oracle, _ = _oracle_and_batch()
    path = str(tmp_path / "oracle.safetensors")
    save_file({k: v.contiguous() for k, v in oracle.state_dict().items()}, path)
    model = FlairHubModel(_config())
    report = load_checkpoint(model, path)
    assert not report["missing"] and not report["unused"] and not report["shape_mismatch"]
    assert report["matched_tasks"] == [TASK] and not report["reinit_tasks"]
    n_utae = sum(1 for k in model.state_dict() if k.startswith("encoders.SENTINEL2_TS."))
    assert report["coverage"]["encoders.SENTINEL2_TS"] == (n_utae, n_utae)
    assert report["coverage"]["fusion_handler"] == (8, 8)  # four 1x1 convs
    q = "encoders.SENTINEL2_TS.temporal_encoder.attention_heads.Q"
    torch.testing.assert_close(model.state_dict()[q], oracle.state_dict()[q], rtol=0, atol=0)
    w = "encoders.SENTINEL2_TS.temporal_encoder.inconv.weight"
    torch.testing.assert_close(model.state_dict()[w], oracle.state_dict()[w][:, :, 0],
                               rtol=0, atol=0)
