"""Profile metrics and objective scoring.

Parity with ``dynamics/metrics.py``: 3-class profiles, the 16-objective
``metric2objective`` table, convergence-run analysis (wrapped runs of 1s
followed by 0s) and convergence ranges from final orientations.
Pure numpy on host (these summarize small per-pair arrays).

PyTorch port: numpy copy of ``dgdm_tpu/eval/metrics.py``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from perfbench.reference.config import NORM


def three_class(x: np.ndarray, threshold: float) -> np.ndarray:
    """0 = below -threshold (cw/up/left), 1 = none, 2 = above threshold."""
    return np.where(x > threshold, 2, np.where(x < -threshold, 0, 1))


def profile_metrics_2d(
    delta_theta: np.ndarray,
    delta_pos: np.ndarray,
    final_theta: np.ndarray,
    obj_theta: np.ndarray,
    final_pos: np.ndarray,
) -> Dict[str, np.ndarray]:
    """The metric dict of the reference eval worker
    (``dynamics/sim_test_mj.py:209-218``): degrees/centimeters units, classes
    shifted to {0,1,2}."""
    th = NORM.threshold_2d
    final_delta = np.asarray(
        [wrap_pi(f - i) for f, i in zip(final_theta, obj_theta)]
    )
    return {
        "delta_theta": delta_theta * 180.0 / np.pi,
        "delta_pos": delta_pos * 100.0,
        "profile": three_class(delta_theta, th[0]),
        "profile_x": three_class(delta_pos[:, 0], th[1]),
        "profile_y": three_class(delta_pos[:, 1], th[2]),
        "final_theta": final_theta * 180.0 / np.pi,
        "final_delta_theta": final_delta * 180.0 / np.pi,
        "final_pos": final_pos * 100.0,
    }


def wrap_pi(x: float) -> float:
    return (x + np.pi) % (2 * np.pi) - np.pi


def convergence_range_from_finals(
    finals: Sequence[float], threshold: float = 0.1
) -> List[Tuple[int, int]]:
    """Consecutive index ranges where final orientations stay within a band
    (dynamics/metrics.py:40-65)."""
    ranges = []
    start = end = 0
    lo = hi = finals[0]
    for i in range(1, len(finals)):
        lo, hi = min(lo, finals[i]), max(hi, finals[i])
        if hi - lo <= threshold:
            end = i
        else:
            if end - start >= 1:
                ranges.append((start, end))
            start = end = i
            lo = hi = finals[i]
    if end - start >= 1:
        ranges.append((start, end))
    return ranges


def _max_range(finals, threshold):
    r = convergence_range_from_finals(finals, threshold)
    return max((e - s for s, e in r), default=0)


def metric2objective(metric: Dict[str, np.ndarray], objective: str) -> Dict:
    """Per-objective scalar summaries (dynamics/metrics.py:67-234)."""
    p, px, py = metric["profile"], metric["profile_x"], metric["profile_y"]
    out: Dict[str, object] = {}
    if objective == "rotate":
        return {
            "success_rate": float(np.mean((p == 0) | (p == 2))),
            "num_zero_classes": int(np.sum(p == 1)),
            "delta_theta_abs": float(np.mean(np.abs(metric["delta_theta"]))),
            "final_delta_theta_abs": float(
                np.mean(np.abs(metric["final_delta_theta"]))
            ),
        }
    if objective == "convergence":
        f = metric["final_theta"]
        return {
            "max_convergence_range_3deg": _max_range(f, 3),
            "max_convergence_range_5deg": _max_range(f, 5),
            "max_convergence_range_10deg": _max_range(f, 10),
        }
    rot_part = None
    if "clockwise" in objective:
        # NB "rotate_counterclockwise" does NOT start with "counter" — detect
        # the ccw family by substring, or the ccw objective is scored as cw.
        cw = "counterclockwise" not in objective
        cls_val = 0 if cw else 2
        key = "clockwise" if cw else "counterclockwise"
        rot_part = (cls_val, key)
    if objective in ("rotate_clockwise", "rotate_counterclockwise"):
        cls_val, key = rot_part
        return {
            "success_rate": float(np.mean(p == cls_val)),
            f"num_{key}_classes": int(np.sum(p == cls_val)),
            "delta_theta": float(np.mean(metric["delta_theta"])),
            "final_delta_theta": float(np.mean(metric["final_delta_theta"])),
        }
    shift_specs = {
        "up": (px, 0, "delta_pos", 0, "final_pos", 0),
        "down": (px, 2, "delta_pos", 0, "final_pos", 0),
        "left": (py, 0, "delta_pos", 1, "final_pos", 1),
        "right": (py, 2, "delta_pos", 1, "final_pos", 1),
    }
    if objective.startswith("shift_"):
        d = objective.split("_")[1]
        prof, cls_val, dk, di, fk, fi = shift_specs[d]
        ax = "x" if di == 0 else "y"
        return {
            "success_rate": float(np.mean(prof == cls_val)),
            f"num_{d}_classes": int(np.sum(prof == cls_val)),
            f"delta_pos_{ax}": float(np.mean(metric[dk][:, di])),
            f"final_pos_{ax}": float(np.mean(metric[fk][:, fi])),
        }
    # combined rotate+shift objectives, e.g. 'clockwise_up'
    rot_key, d = objective.rsplit("_", 1)
    cw = rot_key == "clockwise"
    rot_cls = 0 if cw else 2
    rname = "clockwise" if cw else "counterclockwise"
    prof, cls_val, dk, di, fk, fi = shift_specs[d]
    ax = "x" if di == 0 else "y"
    n_rot = int(np.sum(p == rot_cls))
    n_shift = int(np.sum(prof == cls_val))
    return {
        "success_rate": float(np.mean((p == rot_cls) & (prof == cls_val))),
        f"num_{rname}_{d}_classes": n_rot + n_shift,
        f"num_{rname}_classes": n_rot,
        "delta_theta": float(np.mean(metric["delta_theta"])),
        "final_delta_theta": float(np.mean(metric["final_delta_theta"])),
        f"num_{d}_classes": n_shift,
        f"delta_pos_{ax}": float(np.mean(metric[dk][:, di])),
        f"final_pos_{ax}": float(np.mean(metric[fk][:, fi])),
    }


def best_ids_all_metrics(
    objectives: List[Dict], objective: str
) -> Dict[str, int]:
    """argmax/argmin gripper index per metric (generator/diffusion.py:391-428).
    Minimized metrics: anything clockwise-negative (delta_theta for cw,
    delta_pos toward negative axis directions, num_zero_classes)."""
    keys = objectives[0].keys()
    minimize = set()
    if objective in ("rotate", "rotate_in_place"):
        minimize = {"num_zero_classes"}
    if "clockwise" in objective and "counterclockwise" not in objective:
        minimize |= {"delta_theta", "final_delta_theta"}
    if "up" in objective:
        minimize |= {"delta_pos_x", "final_pos_x"}
    if "left" in objective:
        minimize |= {"delta_pos_y", "final_pos_y"}
    out = {}
    for k in keys:
        vals = [o[k] for o in objectives]
        out[k] = int(np.argmin(vals) if k in minimize else np.argmax(vals))
    return out


def average_objectives(per_object: List[List[Dict]]) -> List[Dict]:
    """Per-gripper objective dicts averaged over objects.

    The reference's multi-object guided path evaluates every gripper on
    every test object, means each objective metric over objects, and only
    then picks best grippers (generator/diffusion.py:686-689:
    ``average_objectives = {k: np.mean([obj[k] for obj in objectives])}``).
    ``per_object`` is indexed [object][gripper] -> metric dict; the return
    is indexed [gripper] and feeds ``best_ids_all_metrics``.
    """
    n_grippers = len(per_object[0])
    out = []
    for gi in range(n_grippers):
        keys = per_object[0][gi].keys()
        out.append({
            k: float(np.mean([po[gi][k] for po in per_object])) for k in keys
        })
    return out
