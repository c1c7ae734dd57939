"""Device ms of the training step's backward (the gradients and their sum
over the group) per traced step: the CUDA-event time of the port's span
``train.backward``, summed by ``utils/profiling.py device_times`` over the
steps run under the profiler (the traced units alone: no other profiler
session runs) over their count. None where the port has no such span."""


def read(ctx):
    from flair_for_aigle_tpu_torch.utils import profiling

    device_times = getattr(profiling, "device_times", None)
    if device_times is None or ctx.summary is None:
        return None
    ms, spans = device_times().get("train.backward", (0.0, 0))
    return ms / spans if spans else None
