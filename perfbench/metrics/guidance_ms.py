"""guidance_ms: the mean host-clock span of a design request's guided
sampling (UNet epsilon, the classifier's gradient over the pose grid, the
DDIM updates), ending when the samples reach the host."""


def read(window):
    reqs = window.records.get("requests") or []
    if not reqs:
        return None
    return 1e3 * window.spans.total("guidance", window.t0, window.t1) \
        / len(reqs)
