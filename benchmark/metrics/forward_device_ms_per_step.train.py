"""Device ms of the training step's forward (model and loss) per traced
step: the CUDA-event time of the port's span ``train.forward``, summed by
``utils/profiling.py device_times`` over the steps run under the profiler
(the traced units alone: no other profiler session runs) over their
count. None where the port has no such span."""


def read(ctx):
    from flair_for_aigle_tpu_torch.utils import profiling

    device_times = getattr(profiling, "device_times", None)
    if device_times is None or ctx.summary is None:
        return None
    ms, spans = device_times().get("train.forward", (0.0, 0))
    return ms / spans if spans else None
