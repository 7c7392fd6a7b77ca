"""Kernel-module composition with the PyTorch port (counterpart of
``examples/core_compose.py``).

Registers a module that depends on the port's quaternion module, then
prints its dependency order, its composed namespace, the entry points run
on the device and the size of its flattened Python source. On the card by
default; ``--device cpu`` runs the plain PyTorch path::

    python examples/torch_core_compose.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import wgmath_tpu_torch.geometry.quat  # noqa: E402,F401 (registers geometry.quat)
from wgmath_tpu_torch.core.dispatch import resolve_device  # noqa: E402
from wgmath_tpu_torch.core.module import (  # noqa: E402
    EntryPoint,
    KernelModule,
    compile_check,
    compose,
    dependency_order,
    flat_source,
    register_module,
)


def rotate_twice(q, v):
    from wgmath_tpu_torch.geometry import quat
    return quat.mul_vec(q, quat.mul_vec(q, v))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    dev = resolve_device(ap.parse_args().device)
    register_module(KernelModule(
        "examples.rotate_twice",
        deps=("geometry.quat",),
        provides={"rotate_twice": rotate_twice},
        entries={"rotate_twice": EntryPoint(
            fn=rotate_twice,
            example_args=lambda d: (
                torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=d),
                torch.ones((1, 3), device=d)))},
        doc="composition example",
    ))
    print("dependency order:", dependency_order("examples.rotate_twice"))
    ns = compose("examples.rotate_twice")
    print("composed symbols:", sorted(ns)[:8])
    print("compiled entries on", dev, ":",
          compile_check("examples.rotate_twice", device=dev))
    print("flat source bytes:", len(flat_source("examples.rotate_twice")))


if __name__ == "__main__":
    main()
