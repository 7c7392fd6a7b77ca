"""Grid math, capacity buckets, device choice and host-sync accounting.

Counterpart of ``wgmath_tpu/core/dispatch.py``: ``cdiv`` / ``round_up`` size
kernel grids, ``capacity_bucket`` bounds the distinct capacities a run
re-buckets through, ``length_mask`` masks a fixed-capacity buffer. The
JAX package's backend probes (``on_tpu``, ``pallas_interpret``) become
:func:`resolve_device`: the port runs on the card unless the caller asks
for the CPU, and a missing card is an error, never a silent fallback.

Every host read of a device value on the step path goes through
:func:`host_int` / :func:`host_list`, so a run can count its host syncs
(each ``lax.cond`` / ``lax.switch`` of the JAX step became one).

:func:`as_tensor` and :func:`check_kernel_operand` are what the kernel
wrappers of ``ops/`` share: array-likes go to the card, and a kernel is
handed only what it can take.
"""

from __future__ import annotations

import torch

HOST_SYNCS = 0


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def next_power_of_two(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (int(n - 1).bit_length())


def capacity_bucket(n: int, *, floor: int = 1024) -> int:
    """Smallest capacity >= max(n, floor) from the 1.5x-granular ladder
    1024, 1536, 2048, 3072, 4096, 6144, ..."""
    n = max(int(n), floor, 1)
    p = next_power_of_two(n)
    if p // 2 * 3 // 2 >= n and p // 2 * 3 // 2 >= floor:
        return p // 2 * 3 // 2
    return p


def length_mask(capacity: int, count: torch.Tensor) -> torch.Tensor:
    """Validity mask of the first ``count`` slots of a ``capacity`` buffer
    (on ``count``'s device): kernels run over the whole capacity and mask
    the slots from ``count`` on, in place of an indirect dispatch."""
    return (torch.arange(capacity, device=count.device)
            < count.to(torch.int64))


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Raises when CUDA is asked for (explicitly or
    by default) and absent; the CPU is used only when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "wgmath_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def as_tensor(x, device=None) -> torch.Tensor:
    """A tensor is returned as it is, on whatever device it lies; anything
    else (numpy array, list, scalar) goes to ``device``, which defaults to
    the card."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, device=resolve_device(device))


def check_kernel_operand(x: torch.Tensor, what: str, dtypes) -> None:
    """Raise unless ``x`` is a contiguous CUDA tensor of one of ``dtypes``:
    what every hand-written kernel of ``ops/`` is given."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: a CUDA tensor expected, got one on "
                         f"{x.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{what}: dtype {x.dtype} not among {list(dtypes)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: contiguous tensor expected")


def host_int(x) -> int:
    """Read one device scalar on the host (counted as a host sync)."""
    global HOST_SYNCS
    HOST_SYNCS += 1
    return int(x.item())


def host_list(x) -> list:
    """Read a small device vector on the host (counted as one host sync)."""
    global HOST_SYNCS
    HOST_SYNCS += 1
    return [int(v) for v in x.tolist()]


def to_device(x: torch.Tensor, device) -> torch.Tensor:
    """Copy a host tensor to ``device`` without a host sync: through
    pinned memory, queued on the current stream (a CPU device gets ``x``
    itself)."""
    device = torch.device(device)
    if device.type == "cpu":
        return x
    return x.pin_memory().to(device, non_blocking=True)
