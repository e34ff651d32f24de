"""Host time under ``upscale_clip.stack`` (``api.upscale_clip``: the
clip's ``np.stack`` of its HR frames), ms a served frame."""

from vsr_bench import spans


def read(t):
    return spans.host_ms(t, "upscale_clip.stack")
