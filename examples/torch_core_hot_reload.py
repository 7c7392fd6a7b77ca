"""Hot reload with the PyTorch port (counterpart of
``examples/core_hot_reload.py``): watch a kernel module's source, report
it stale after an edit (here the file's time is touched), reload it in
place (the loaded kernel libraries are dropped with it) and run the
reloaded module's entry points on the device. On the card by default,
where that builds and launches the GEMM kernel; ``--device cpu`` runs its
plain version::

    python examples/torch_core_hot_reload.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import wgmath_tpu_torch.ops.gemm  # noqa: E402,F401 (registers linalg.gemm)
from wgmath_tpu_torch.core import module as m  # noqa: E402
from wgmath_tpu_torch.core.dispatch import resolve_device  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    dev = resolve_device(ap.parse_args().device)
    stamps = m.watch_sources(["linalg.gemm"])
    print("watching:", {name: round(t) for name, t in stamps.items()})
    src = m.get_module("linalg.gemm")
    path = sys.modules[src.provides["gemm"].__module__].__file__
    os.utime(path)  # as if the file had been edited
    stale = m.needs_reload(stamps)
    print("stale after edit:", stale)
    for name in stale:
        m.reload(name)
    print("reloaded ok:", bool(m.get_module("linalg.gemm")))
    print("reloaded entries on", dev, ":",
          m.compile_check("linalg.gemm", device=dev))


if __name__ == "__main__":
    main()
