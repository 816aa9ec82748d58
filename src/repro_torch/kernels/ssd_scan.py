"""Mamba2 SSD chunked scan on the card: wrapper of ``csrc/ssd_scan.cu``.

Replaces ``repro.kernels.ssd_scan.ssd_scan_pallas``. The plain version is
the sequential ``ref.ssd_scan_ref``; ``ops.ssd_scan`` picks between them.
Unlike the Pallas form, the kernel takes any T: the last chunk may be short.

A call is three launches over (batch*head, chunk), each on the current
stream: the chunk states, the state passing across chunks, and the chunk
scan (``PHASES``). The scan has two instances, and :func:`instance` picks
one by dtype and shape: bf16 with N a multiple of 16 and P in
``TC_HEAD_DIMS`` runs its products on the tensor cores (``mma.sync`` in
bf16), everything else on the CUDA cores in float32 (which holds float32's
3e-4; TF32 would not). ``ref.ssd_scan_chunked`` is the same decomposition in
plain PyTorch, for the tests.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0  # calls that launched the kernels since the last reset
kernel_launches = 0  # device launches: three a call
INSTANCES = ("tensor_core", "cuda_core")
instance_launches = dict.fromkeys(INSTANCES, 0)  # calls per instance of the chunk scan
PHASES = ("chunk_state", "state_passing", "chunk_scan")

DTYPES = (torch.float32, torch.bfloat16)  # of x, B, C and y
TC_HEAD_DIMS = (16, 32, 64, 128)  # P of the tensor-core instance's template instances
MAX_SHARED_BYTES = 232_448  # one H100 block's shared memory (227 KB)
MAX_CHUNKS = 65535  # the grid's y extent
STATE_THREADS = 128  # threads of a chunk-state block (csrc/ssd_scan.cu)


def instance(dtype: torch.dtype, n: int, p: int) -> str:
    """The chunk-scan instance that takes a call of this dtype, state size N
    and head dim P."""
    if dtype == torch.bfloat16 and n % 16 == 0 and p in TC_HEAD_DIMS:
        return "tensor_core"
    return "cuda_core"


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def smem_bytes(chunk: int, p: int, n: int,
               dtype: torch.dtype = torch.float32) -> dict[str, int]:
    """Dynamic shared memory of one block of the chunk-state and chunk-scan
    phases (state passing takes none) for x, B, C of ``dtype``, as
    ``csrc/ssd_scan.cu`` sizes it, with Lp the chunk rounded up to 16.

    Chunk state: w_j B_j (Lp, N), which later holds the thread groups'
    partial sums (at least 16 floats a thread), dt and cum, 32 warp totals in
    float32; x (Lp, P) and B (Lp, N) in ``dtype``, N padded to 4. Chunk scan
    on the CUDA cores: C^T and B^T (N, Lp), the (N, P) state later in B^T's
    room, the (Lp, Lp) decay-weighted C B^T, cum and dt in float32, x (Lp, P)
    in ``dtype``. On the tensor cores: the state,
    cum and dt in float32, x (Lp, P+8) and B, C (Lp, N+8) in bf16 (rows
    padded by 16 bytes).
    """
    lp, p4, n4 = _up(chunk, 16), _up(p, 4), _up(n, 4)
    esize = torch.empty((), dtype=dtype).element_size()
    state = 4 * (max(lp * n4, 16 * STATE_THREADS) + 2 * lp + 32) + esize * (lp * p4 + lp * n4)
    if instance(dtype, n, p) == "tensor_core":
        scan = 4 * (n * p + 2 * lp) + 2 * (lp * (p + 8) + 2 * lp * (n + 8))
    else:
        scan = 4 * (n * lp + n * max(lp, p4) + lp * lp + 2 * lp) + esize * lp * p4
    return {"chunk_state": state, "chunk_scan": scan}


def ssd_scan_cuda(
    x: torch.Tensor,  # (B, T, H, P)
    dt: torch.Tensor,  # (B, T, H) float32
    a: torch.Tensor,  # (H,) float32
    b_: torch.Tensor,  # (B, T, G, N)
    c_: torch.Tensor,  # (B, T, G, N)
    d_: torch.Tensor | None = None,  # (H,) float32
    *,
    chunk: int = 128,
    events: list | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, T, H, P) in x's dtype, final state (B, H, N, P) float32).

    ``events``, if a list, receives four CUDA events that the kernel library
    records before the first phase and after each, for timing the phases one
    by one.
    """
    global launches, kernel_launches
    _build.require(x, "ssd_scan x", DTYPES, 4)
    _build.require(dt, "ssd_scan dt", torch.float32, 3)
    _build.require(a, "ssd_scan a", torch.float32, 1)
    _build.require(b_, "ssd_scan B", x.dtype, 4)
    _build.require(c_, "ssd_scan C", x.dtype, 4)
    bsz, t, h, p = x.shape
    g, n = b_.shape[2], b_.shape[3]
    if d_ is None:
        d_ = torch.zeros((h,), dtype=torch.float32, device=x.device)
    _build.require(d_, "ssd_scan D", torch.float32, 1)
    if (tuple(dt.shape) != (bsz, t, h) or tuple(a.shape) != (h,) or tuple(d_.shape) != (h,)
            or b_.shape != c_.shape or tuple(b_.shape[:2]) != (bsz, t)):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"a {tuple(a.shape)}, B {tuple(b_.shape)}, C {tuple(c_.shape)}, "
                         f"D {tuple(d_.shape)} do not agree")
    if any(u.device != x.device for u in (dt, a, b_, c_, d_)):
        raise ValueError("ssd_scan: every input must be on x's device")
    if g < 1 or h % g:
        raise ValueError(f"ssd_scan: {h} heads do not group over {g} B/C groups")
    y = torch.empty_like(x)
    if t == 0 or bsz * h == 0:
        return y, torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    chunk = max(1, min(chunk, t))
    nc = -(-t // chunk)
    which = instance(x.dtype, n, p)
    for phase, nbytes in smem_bytes(chunk, p, n, x.dtype).items():
        if nbytes > MAX_SHARED_BYTES:
            raise ValueError(f"ssd_scan: chunk {chunk} with P={p}, N={n} needs {nbytes} bytes "
                             f"of shared memory in {phase}; a block has {MAX_SHARED_BYTES}")
    if nc > MAX_CHUNKS:
        raise ValueError(f"ssd_scan: T {t} needs more than {MAX_CHUNKS} chunks of {chunk}")
    if x.numel() >= 2**62 or bsz * h * n * p >= 2**31:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)} is too large")
    if which == "tensor_core" and any(u.data_ptr() % 16 for u in (x, b_, c_)):
        raise ValueError("ssd_scan: the tensor-core kernel needs 16-byte aligned x, B, C")
    lp = _up(chunk, 16)
    scratch = torch.empty(bsz * h * nc * (2 * lp + n * p), dtype=torch.float32, device=x.device)
    ncd = bsz * h * nc * 2 * lp  # cd (B*H, nc, 2, Lp), then the states (B, H, nc, N, P)
    hf = torch.empty((bsz, h, n, p), dtype=torch.float32, device=x.device)
    handles = None if events is None else _build.event_handles(events, len(PHASES) + 1)
    with torch.cuda.device(x.device):
        code = _build.lib().rt_ssd_scan(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_.data_ptr(), c_.data_ptr(),
            d_.data_ptr(), scratch.data_ptr(), scratch.data_ptr() + 4 * ncd, y.data_ptr(),
            hf.data_ptr(), bsz, t, h, p, g, n, chunk, int(x.dtype == torch.bfloat16),
            int(which == "tensor_core"), handles, _build.stream(x))
        with _build.counter_lock:
            launches += 1
            kernel_launches += len(PHASES)
            instance_launches[which] += 1
    _build.check(code, f"ssd_scan ({which})")
    return y, hf
