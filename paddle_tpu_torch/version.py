"""Version info (counterpart of ``paddle_tpu/version.py``; reference:
paddle/utils/Version.cpp, cmake version stamping).

major/minor/patch are derived from __version__ so the two can never
drift; ``paddle_tpu_torch.__version__`` is imported from here. The port
runs on a CUDA card, so ``with_tpu`` is False.
"""

__version__ = "0.1.0"

major, minor, patch = (int(p) for p in __version__.split("."))
rc = 0
istaged = False
with_tpu = False


def show():
    print("paddle_tpu_torch", __version__)
