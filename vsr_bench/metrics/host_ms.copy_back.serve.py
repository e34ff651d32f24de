"""Host time under ``upscale_clip.copy_back`` (``api.upscale_clip``: a
frame's ``.cpu().numpy()``), ms a served frame: the wait for the frame's
kernels, the pageable copy to the host and its page faults.
``memcpy_ms.serve`` beside it gives the copies' own device time."""

from vsr_bench import spans


def read(t):
    return spans.host_ms(t, "upscale_clip.copy_back")
