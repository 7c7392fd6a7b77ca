"""Registry override with the PyTorch port (counterpart of
``examples/core_overwrite.py``): replace a registered dependency module
(``register_module(..., allow_replace=True)``) and the dependent kernel,
which composes its dependency at every call, picks up the new
implementation. On the card by default; ``--device cpu`` runs on the CPU::

    python examples/torch_core_overwrite.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from wgmath_tpu_torch.core.dispatch import resolve_device  # noqa: E402
from wgmath_tpu_torch.core.module import (  # noqa: E402
    EntryPoint,
    KernelModule,
    compose,
    register_module,
)


def kernel(a, b):
    shared = compose("examples.composable")["shared_value"]
    return shared(a) + b


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    dev = resolve_device(ap.parse_args().device)
    # the dependency
    register_module(KernelModule(
        "examples.composable",
        provides={"shared_value": lambda a: a * 10.0},
        doc="original dependency",
    ))
    # the dependent kernel
    register_module(KernelModule(
        "examples.overwrite_kernel",
        deps=("examples.composable",),
        provides={"kernel": kernel},
        entries={"kernel": EntryPoint(
            fn=kernel,
            example_args=lambda d: (torch.ones(4, device=d),
                                    torch.ones(4, device=d)))},
        doc="overwrite example",
    ))
    a = torch.arange(4, dtype=torch.float32, device=dev)
    b = a * 100.0
    before = kernel(a, b).tolist()
    print("Result before overwrite:", before)
    # overwrite the dependency in place
    register_module(KernelModule(
        "examples.composable",
        provides={"shared_value": lambda a: a * 1000.0},
        doc="overwritten dependency",
    ), allow_replace=True)
    after = kernel(a, b).tolist()
    print("Result after overwrite: ", after)
    assert after != before
    print("dependency override propagated through composition")


if __name__ == "__main__":
    main()
