"""PyTorch + CUDA port of ``dgdm_tpu`` for NVIDIA Hopper (H100).

Mirrors ``dgdm_tpu``'s sub-packages and module names; each module's
docstring names its counterpart. The port imports ``torch`` and numpy, never
JAX or anything of ``dgdm_tpu``. Entry points take an explicit ``device``
(default ``"cuda"``); only an explicit ``device="cpu"`` selects the plain
PyTorch versions of the hand-written kernels.
"""
