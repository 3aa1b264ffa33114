"""verify_host_ms: the mean span of a request's verification call
(``sim_eval_batch_2d``: host scene build, upload, K1, metrics) less the
device time of the rollout kernel inside it, from the trace."""

KERNEL = "rollout2d_kernel"


def read(window):
    reqs = window.records.get("requests") or []
    if not reqs or window.kernels is None:
        return None
    total = 0.0
    for name, s, e in window.spans.items:
        if name == "verify_host" and s >= window.t0 and e <= window.t1:
            total += (e - s) - window.kernel_seconds(KERNEL, s, e)
    return 1e3 * total / len(reqs)
