"""Device buffer readback with the PyTorch port (counterpart of
``examples/core_readback.py``): copy a host buffer to the device, read it
back and compare it with the original, then read back a strided column of
a matrix buffer through ``core.tensor.View``. The buffer is uint32, carried
as int32 bits (PyTorch's CUDA copies of unsigned 32-bit tensors are not
everywhere supported). On the card by default; ``--device cpu`` runs on the
CPU::

    python examples/torch_core_readback.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from wgmath_tpu_torch.core.dispatch import resolve_device  # noqa: E402
from wgmath_tpu_torch.core.tensor import View  # noqa: E402

LEN = 10


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    dev = resolve_device(ap.parse_args().device)
    host = np.arange(LEN, dtype=np.uint32)
    buffer = torch.from_numpy(host.view(np.int32)).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print("device:", buffer.device)
    read = buffer.cpu().numpy().view(np.uint32)
    assert np.array_equal(host, read)
    print("Buffer copy & read succeeded!")
    print("Original:", host.tolist())
    print("Readback:", read.tolist())
    # a column view of a matrix buffer (column-major flat storage)
    mat = np.arange(12, dtype=np.float32).reshape(3, 4)
    buf = torch.from_numpy(mat.T.flatten()).to(dev)
    col = View(buf, (3, 4, 1), 3, 12, 0).column(2)
    col_read = col.to_vector().cpu().numpy()
    assert np.array_equal(col_read, mat[:, 2])
    print("View column readback:", col_read.tolist())


if __name__ == "__main__":
    main()
