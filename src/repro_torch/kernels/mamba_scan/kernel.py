"""K11: the selective scan, hand-written for Hopper, its wrappers and the
autograd Function of the Mamba-1 model's form.

Ports ``repro.kernels.mamba_scan.kernel.mamba_scan`` (the recurrence
``h[t] = dA[t]·h[t-1] + dBx[t]``, ``y[t] = <h[t], C[t]>``; see ``ref.py``)
with three entry points over one CUDA body (``csrc/mamba_scan.cu``, built
by ``repro_torch.kernels.build``; a thread a channel, its N states in
registers):

* ``mamba_scan(dA, dBx, C, h0)``: the Pallas kernel's contract, for the
  parity tests; y and hT in ``dA.dtype``;
* ``mamba_scan_model(dt, A, x, Bc, Cc, h0)``: the tensors
  ``layers.ssm.apply_mamba1`` has; the kernel discretizes
  (``dA = exp2(dt·A·log2 e)``, ``dBx = (dt·x)·B``) itself, so the
  (B, S, E, N) dA and dBx never reach device memory; y and hT in fp32.
  dt, x, Bc and Cc are in the model's dtype (float32 or bfloat16), A fp32,
  h0 fp32 or bfloat16.  Where the batch's channels leave the card's
  thread slots mostly empty, time is cut into ``scan_parts`` chunks (a
  pass of chunk end states, then the chunks rerun from their true
  starts); a decode step (S 1) runs a one-step kernel;
* ``mamba_scan_heads(dt, A, x, Bc, Cc, h0)``: the head-shared form that
  ``layers.ssm.apply_mamba2`` (Mamba-2) has, one dt and one A a head:
  dt (B, S, H) and A (H,) fp32, x (B, S, H·P), Bc and Cc (B, S, N) in the
  model's dtype, h0 (B, H, P, N) fp32 or bfloat16; dA = exp2(dt·A·log2 e)
  is one exponential a head and step; y (B, S, H, P) in fp32 and hT in
  h0's dtype (rounded to nearest even in the kernel, the reference's
  cast).  At a head dim of 64 (N 16, 32 or 64: zamba2's heads) and S > 1
  it runs as a chunked scan on the tensor cores (``csrc/ssd_scan.cuh``,
  ``body`` gives ``ssd``): chunks of 64 steps as matrix products in three
  launches, the chunks' end states (a CTA a chunk, batch row and
  ``chunk_heads`` heads), their fold in order into each chunk's start
  state and hT, then y.
  Every other shape keeps the thread-a-channel kernel (``head_scan``, time
  chunks as the model form), and S = 1 its one-step kernel
  (``head_step``); ``launch_scan_heads`` forces the thread-a-channel body
  and ``launch_scan_heads_chunked`` the chunked one.

N (the state size) is one of 1, 2, 4, 8, 16, 32 (the head-shared form: 16,
32, 64); E, P and S >= 1 are free.
``mamba1_scan`` and ``mamba2_scan`` are the models' entry points: autograd
Functions whose forwards are ``mamba_scan_model`` and ``mamba_scan_heads``
and whose backwards are plain and recompute from the inputs:
``ref.scan_model_grads`` (the adjoint stepped back in time) and
``ref.scan_heads_grads`` (the chunked form differentiated, no loop over
time).  The reference differentiates its ``lax.scan``s; no backward kernel
yet.  ``mamba2_scan`` calls ``mamba_scan_heads`` directly where nothing
needs a gradient (serving).

The wrappers choose by the tensors' device: on the CPU they run the plain
versions, on a CUDA device they launch the kernel or raise.  There is no
fallback.  On ``meta`` (the dry run's abstract step) each is one op of the
``repro_torch`` namespace that has only a meta implementation
(``k11_scan``, ``k11_scan_model``, ``k11_scan_heads``): the outputs' shapes
in one dispatch, where the plain versions step through time in Python, so
an abstract step costs the same at any S, and a counter sees the kernel's
own traffic (its inputs read once, its outputs written once).  The
head-shared op's FLOPs are those of the plain version's product
``y = h·C`` a step (2·B·S·H·P·N, the reference's ``dot`` in its scan's
body); the other forms do no matrix product.  The backwards stay plain
on ``meta``, as they run on the card.  ``mamba_scan.launches`` and
``mamba_scan_model.launches`` count wrapper calls that launched the
kernel (one a call, whatever its passes), and so does
``mamba_scan_heads.launches``.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.build import (DTYPE_CODE, check_launch, count_launch,
                                      cuda_entry)
from repro_torch.kernels.build import resources as _resources
from repro_torch.kernels.mamba_scan.ref import (reference, scan_heads,
                                                scan_heads_grads, scan_model,
                                                scan_model_grads)

STATE_SIZES = (1, 2, 4, 8, 16, 32)     # N: the instantiated state sizes
HEAD_STATE_SIZES = (16, 32, 64)        # N of the head-shared form
CHUNKED_HEAD_DIM = 64                  # P of its chunked route
CHUNK = 64                             # steps a chunk of the chunked route
MAX_CHUNK_HEADS = 8                    # heads a chunk CTA, at most
MAX_BATCH = 65535                      # the grid's y dimension
MAX_PARTS = 16                         # time chunks a call
MIN_CHUNK = 64                         # time steps a chunk, at least


def _meta_scan(dA, dBx, C, h0):
    B, S, E, N = dA.shape
    return dA.new_empty((B, S, E)), dA.new_empty((B, E, N))


def _meta_scan_model(dt, A, x, Bc, Cc, h0):
    (B, S, E), N = dt.shape, A.shape[-1]
    return (dt.new_empty((B, S, E), dtype=torch.float32),
            dt.new_empty((B, E, N), dtype=torch.float32))


def _meta_scan_heads(dt, A, x, Bc, Cc, h0):
    B, S, H = dt.shape
    return (dt.new_empty((B, S, H, x.shape[-1] // H), dtype=torch.float32),
            h0.new_empty(h0.shape))


_META = torch.library.Library("repro_torch", "FRAGMENT")
for _name, _args, _fn in (
        ("k11_scan", "Tensor dA, Tensor dBx, Tensor C, Tensor h0",
         _meta_scan),
        ("k11_scan_model", "Tensor dt, Tensor A, Tensor x, Tensor Bc, "
         "Tensor Cc, Tensor h0", _meta_scan_model),
        ("k11_scan_heads", "Tensor dt, Tensor A, Tensor x, Tensor Bc, "
         "Tensor Cc, Tensor h0", _meta_scan_heads)):
    _META.define(f"{_name}({_args}) -> (Tensor, Tensor)")
    _META.impl(_name, _fn, "Meta")


@register_flop_formula(torch.ops.repro_torch.k11_scan_heads)
def _scan_heads_flops(dt_shape, A_shape, x_shape, Bc_shape, *_, **__):
    B, S, H = dt_shape
    return 2 * B * S * x_shape[-1] * Bc_shape[-1]


def _check_common(name, tensors, B, S, E, N) -> None:
    first = tensors[0]
    if first.device.type != "cuda":
        raise ValueError(f"{name} kernel runs on CUDA tensors, got "
                         f"{first.device}")
    if any(t.device != first.device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} kernel needs contiguous tensors")
    if N not in STATE_SIZES:
        raise ValueError(f"{name} kernel: state size {N} not in "
                         f"{STATE_SIZES}")
    if not (1 <= B <= MAX_BATCH and S >= 1 and E >= 1):
        raise ValueError(f"{name} kernel: B={B} (1..{MAX_BATCH}), S={S} and "
                         f"E={E} (>= 1)")


def check_cuda_args(dA, dBx, C, h0) -> None:
    """Raise on anything the contract form of the kernel does not take."""
    if dA.ndim != 4:
        raise ValueError(f"mamba_scan: dA {tuple(dA.shape)}, want "
                         f"(B, S, E, N)")
    B, S, E, N = dA.shape
    _check_common("mamba_scan", (dA, dBx, C, h0), B, S, E, N)
    if dA.dtype not in DTYPE_CODE or any(t.dtype != dA.dtype
                                         for t in (dBx, C, h0)):
        raise TypeError(f"mamba_scan kernel takes float32 or bfloat16 dA, "
                        f"dBx, C and h0 of one dtype, got {dA.dtype}, "
                        f"{dBx.dtype}, {C.dtype}, {h0.dtype}")
    if dBx.shape != dA.shape or C.shape != (B, S, N) \
            or h0.shape != (B, E, N):
        raise ValueError(f"mamba_scan: dBx {tuple(dBx.shape)}, C "
                         f"{tuple(C.shape)}, h0 {tuple(h0.shape)} do not "
                         f"match dA {tuple(dA.shape)}")


def check_cuda_args_model(dt, A, x, Bc, Cc, h0) -> tuple:
    """Raise on anything the model form of the kernel does not take; else
    return (B, S, E, N, the device's index).  It runs before every launch,
    a decode step's among them, where the wrapper's host work is most of
    K11's time: each tensor attribute is read once."""
    shape, a_shape = dt.shape, A.shape
    if len(shape) != 3 or len(a_shape) != 2:
        raise ValueError(f"mamba_scan_model: dt {tuple(shape)}, A "
                         f"{tuple(a_shape)}, want (B, S, E) and (E, N)")
    (B, S, E), N = shape, a_shape[1]
    index = dt.get_device()
    if index < 0:
        raise ValueError(f"mamba_scan_model kernel runs on CUDA tensors, got "
                         f"{dt.device}")
    others = (A, x, Bc, Cc, h0)
    if any(t.get_device() != index for t in others):
        raise ValueError("mamba_scan_model: all tensors must be on one "
                         "device")
    if not (dt.is_contiguous() and all(t.is_contiguous() for t in others)):
        raise ValueError("mamba_scan_model kernel needs contiguous tensors")
    if N not in STATE_SIZES:
        raise ValueError(f"mamba_scan_model kernel: state size {N} not in "
                         f"{STATE_SIZES}")
    if not (1 <= B <= MAX_BATCH and S >= 1 and E >= 1):
        raise ValueError(f"mamba_scan_model kernel: B={B} (1..{MAX_BATCH}), "
                         f"S={S} and E={E} (>= 1)")
    dtype = dt.dtype
    if dtype not in DTYPE_CODE or x.dtype != dtype or Bc.dtype != dtype \
            or Cc.dtype != dtype:
        raise TypeError(f"mamba_scan_model kernel takes float32 or bfloat16 "
                        f"dt, x, Bc and Cc of one dtype, got {dtype}, "
                        f"{x.dtype}, {Bc.dtype}, {Cc.dtype}")
    if A.dtype != torch.float32 or h0.dtype not in DTYPE_CODE:
        raise TypeError(f"mamba_scan_model kernel takes float32 A and a "
                        f"float32 or bfloat16 h0, got {A.dtype}, {h0.dtype}")
    if x.shape != shape or a_shape != (E, N) or Bc.shape != (B, S, N) \
            or Cc.shape != (B, S, N) or h0.shape != (B, E, N):
        raise ValueError(f"mamba_scan_model: x {tuple(x.shape)}, A "
                         f"{tuple(a_shape)}, Bc {tuple(Bc.shape)}, Cc "
                         f"{tuple(Cc.shape)}, h0 {tuple(h0.shape)} do not "
                         f"match dt {tuple(shape)}")
    return B, S, E, N, index


def mamba_scan(dA: torch.Tensor, dBx: torch.Tensor, C: torch.Tensor,
               h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K11, the Pallas contract: -> (y (B, S, E), hT (B, E, N)) in dA.dtype.

    CPU tensors run ``ref.reference`` (meta ones ``k11_scan``); CUDA
    tensors launch the Hopper kernel on the current stream (a CTA per 128
    channels of a batch row, the whole of time in one chunk)."""
    if dA.device.type == "cpu":
        return reference(dA, dBx, C, h0)
    if dA.is_meta:
        return torch.ops.repro_torch.k11_scan(dA, dBx, C, h0)
    check_cuda_args(dA, dBx, C, h0)
    B, S, E, N = dA.shape
    y = torch.empty((B, S, E), dtype=dA.dtype, device=dA.device)
    hT = torch.empty((B, E, N), dtype=dA.dtype, device=dA.device)
    err = cuda_entry("mamba_scan_contract")(
        DTYPE_CODE[dA.dtype], N, dA.data_ptr(), dBx.data_ptr(), C.data_ptr(),
        h0.data_ptr(), y.data_ptr(), hT.data_ptr(), B, S, E,
        torch.cuda.current_stream(dA.device).cuda_stream)
    check_launch("mamba_scan_contract", err)
    count_launch(mamba_scan)
    return y, hT


mamba_scan.launches = 0


def parts_rule(ctas: int, S: int, sms: int, per_sm: int) -> int:
    """Time chunks for a scan of ``ctas`` CTAs of channels over S steps on
    ``sms`` SMs that hold ``per_sm`` CTAs each: 1 where the CTAs outnumber
    the SMs (a pass then keeps every SM busy, and more passes only add
    work: on an H100, B 4 at falcon-mamba's width ran slower in 2 chunks
    than in 1); else as many as fill the card's CTA slots, at most
    ``MAX_PARTS`` and at most S // ``MIN_CHUNK``."""
    if ctas > sms:
        return 1
    return max(1, min(MAX_PARTS, per_sm * sms // ctas, S // MIN_CHUNK))


@functools.lru_cache(maxsize=None)
def scan_parts(code: int, h0_code: int, N: int, B: int, S: int, E: int,
               index: int, query: str = "mamba_scan_model_resources") -> int:
    """``parts_rule`` at these shapes, with the CTAs an SM and channels a
    CTA from the scan kernel's occupancy query (``query``: the model
    form's or ``mamba_scan_heads_resources``); 1 for a decode step.
    Cached: shapes only, never the data."""
    if S == 1:
        return 1
    *_, per_sm, per_cta = _resources(query, code, h0_code, N)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return parts_rule(B * -(-E // per_cta), S, sms, per_sm)


def _launch(dt, A, x, Bc, Cc, h0, B, S, E, N, index, parts):
    y = dt.new_empty((B, S, E), dtype=torch.float32)
    hT = dt.new_empty((B, E, N), dtype=torch.float32)
    ws = None if parts == 1 else \
        dt.new_empty(2 * B * (parts - 1) * E * N, dtype=torch.float32)
    # the raw stream handle: a Stream object costs microseconds, and a
    # decode step's time is the wrapper's host work
    err = cuda_entry("mamba_scan_model")(
        DTYPE_CODE[dt.dtype], DTYPE_CODE[h0.dtype], N, dt.data_ptr(),
        A.data_ptr(), x.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
        h0.data_ptr(), y.data_ptr(), hT.data_ptr(),
        None if ws is None else ws.data_ptr(), B, S, E, parts,
        torch._C._cuda_getCurrentRawStream(index))
    check_launch("mamba_scan_model", err)
    return y, hT


def launch_scan_model(dt, A, x, Bc, Cc, h0, parts: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The model form's C entry point on checked CUDA tensors with time in
    ``parts`` chunks (1..16, at most S; 1 where S = 1) -> (y, hT).  Counts
    nothing: the wrapper does, and the tests and the study call this to
    force ``parts``."""
    B, S, E, N, index = check_cuda_args_model(dt, A, x, Bc, Cc, h0)
    return _launch(dt, A, x, Bc, Cc, h0, B, S, E, N, index, parts)


def mamba_scan_model(dt: torch.Tensor, A: torch.Tensor, x: torch.Tensor,
                     Bc: torch.Tensor, Cc: torch.Tensor, h0: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K11, the model's form: -> (y (B, S, E), hT (B, E, N)) in fp32.

    CPU tensors run ``ref.scan_model`` (meta ones ``k11_scan_model``);
    CUDA tensors launch the Hopper kernel on the current stream: a thread
    a channel, time in ``scan_parts`` chunks (one launch on the count)."""
    if dt.device.type == "cpu":
        return scan_model(dt, A, x, Bc, Cc, h0)
    if dt.is_meta:
        return torch.ops.repro_torch.k11_scan_model(dt, A, x, Bc, Cc, h0)
    B, S, E, N, index = check_cuda_args_model(dt, A, x, Bc, Cc, h0)
    parts = scan_parts(DTYPE_CODE[dt.dtype], DTYPE_CODE[h0.dtype], N, B, S,
                       E, index)
    out = _launch(dt, A, x, Bc, Cc, h0, B, S, E, N, index, parts)
    count_launch(mamba_scan_model)
    return out


mamba_scan_model.launches = 0


def check_cuda_args_heads(dt, A, x, Bc, Cc, h0) -> tuple:
    """Raise on anything the head-shared form of the kernel does not take;
    else return (B, S, H, P, N, the device's index).  It runs before every
    launch, a decode step's among them."""
    shape, h_shape = dt.shape, h0.shape
    if len(shape) != 3 or len(h_shape) != 4:
        raise ValueError(f"mamba_scan_heads: dt {tuple(shape)}, h0 "
                         f"{tuple(h_shape)}, want (B, S, H) and (B, H, P, N)")
    (B, S, H), (P, N) = shape, h_shape[2:]
    index = dt.get_device()
    if index < 0:
        raise ValueError(f"mamba_scan_heads kernel runs on CUDA tensors, got "
                         f"{dt.device}")
    others = (A, x, Bc, Cc, h0)
    if any(t.get_device() != index for t in others):
        raise ValueError("mamba_scan_heads: all tensors must be on one "
                         "device")
    if not (dt.is_contiguous() and all(t.is_contiguous() for t in others)):
        raise ValueError("mamba_scan_heads kernel needs contiguous tensors")
    if N not in HEAD_STATE_SIZES:
        raise ValueError(f"mamba_scan_heads kernel: state size {N} not in "
                         f"{HEAD_STATE_SIZES}")
    if not (1 <= B <= MAX_BATCH and S >= 1 and H >= 1 and P >= 1):
        raise ValueError(f"mamba_scan_heads kernel: B={B} (1..{MAX_BATCH}), "
                         f"S={S}, H={H} and P={P} (>= 1)")
    dtype = x.dtype
    if dtype not in DTYPE_CODE or Bc.dtype != dtype or Cc.dtype != dtype:
        raise TypeError(f"mamba_scan_heads kernel takes float32 or bfloat16 "
                        f"x, Bc and Cc of one dtype, got {dtype}, "
                        f"{Bc.dtype}, {Cc.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32 \
            or h0.dtype not in DTYPE_CODE:
        raise TypeError(f"mamba_scan_heads kernel takes float32 dt and A and "
                        f"a float32 or bfloat16 h0, got {dt.dtype}, "
                        f"{A.dtype}, {h0.dtype}")
    if x.shape != (B, S, H * P) or A.shape != (H,) \
            or Bc.shape != (B, S, N) or Cc.shape != (B, S, N) \
            or h_shape[:2] != (B, H):
        raise ValueError(f"mamba_scan_heads: x {tuple(x.shape)}, A "
                         f"{tuple(A.shape)}, Bc {tuple(Bc.shape)}, Cc "
                         f"{tuple(Cc.shape)}, h0 {tuple(h_shape)} do not "
                         f"match dt {tuple(shape)}")
    return B, S, H, P, N, index


def _launch_heads(dt, A, x, Bc, Cc, h0, B, S, H, P, N, index, parts):
    E = H * P
    y = dt.new_empty((B, S, H, P))
    hT = torch.empty_like(h0)
    ws = None if parts == 1 else \
        dt.new_empty(B * (parts - 1) * E * (N + 1))
    err = cuda_entry("mamba_scan_heads")(
        DTYPE_CODE[x.dtype], DTYPE_CODE[h0.dtype], N, dt.data_ptr(),
        A.data_ptr(), x.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
        h0.data_ptr(), y.data_ptr(), hT.data_ptr(),
        None if ws is None else ws.data_ptr(), B, S, H, P, parts,
        torch._C._cuda_getCurrentRawStream(index))
    check_launch("mamba_scan_heads", err)
    return y, hT


def launch_scan_heads(dt, A, x, Bc, Cc, h0, parts: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The head-shared form's thread-a-channel body (``head_scan_kernel``;
    ``head_step_kernel`` where S = 1) on checked CUDA tensors at any shape
    it takes, with time in ``parts`` chunks (1..16, at most S; 1 where S =
    1) -> (y, hT): at P 64 the body the chunked route replaced.  Counts
    nothing, as ``launch_scan_model``."""
    B, S, H, P, N, index = check_cuda_args_heads(dt, A, x, Bc, Cc, h0)
    return _launch_heads(dt, A, x, Bc, Cc, h0, B, S, H, P, N, index, parts)


def body(S: int, P: int, N: int) -> str:
    """The kernel a head-shared call at these shapes launches: ``ssd`` (the
    chunked scan on the tensor cores: P 64, N 16 / 32 / 64, S > 1),
    ``head_step`` (S 1) or ``head_scan`` (a thread a channel: every other
    shape)."""
    if S == 1:
        return "head_step"
    if P == CHUNKED_HEAD_DIM and N in HEAD_STATE_SIZES:
        return "ssd"
    return "head_scan"


def chunk_heads_rule(head_chunks: int, H: int, slots: int) -> int:
    """Heads a chunk CTA takes, of ``head_chunks`` (batch rows x chunks x
    heads) on a card of ``slots`` chunk-CTA slots: the most that divide H,
    at most ``MAX_CHUNK_HEADS``, and leave four waves of CTAs or more; 1
    where there are fewer.  A CTA stages a chunk's Bc and Cc and computes
    Cc Bc^T once for its heads, which pays where CTAs queue; but its heads
    run in turn, so fewer, longer CTAs leave more of the last wave idle.
    On an H100 (264 slots), at zamba2's training shape (5120 head-chunks)
    1, 2, 4, 5 and 8 heads took 0.431, 0.399, 0.383, 0.376 and 0.412 ms
    (19, 9.7, 4.8, 3.9 and 2.4 waves: ``tile_study.py --only
    ssd_heads``); at its prefill span (320) 1 head is the fastest."""
    cap = max(1, min(MAX_CHUNK_HEADS, head_chunks // (4 * slots)))
    return max(d for d in range(1, cap + 1) if H % d == 0)


@functools.lru_cache(maxsize=None)
def chunk_heads(code: int, h0_code: int, N: int, B: int, S: int, H: int,
                index: int) -> int:
    """``chunk_heads_rule`` at these shapes, the slots from the occupancy
    query of the kernel that writes y (pass 3, the larger of the two chunk
    kernels).  Cached: shapes only, never the data."""
    *_, per_sm, _ = _resources("mamba_scan_heads_chunked_resources", code,
                               h0_code, N, 3)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return chunk_heads_rule(B * -(-S // CHUNK) * H, H, per_sm * sms)


def _launch_chunked(dt, A, x, Bc, Cc, h0, B, S, H, P, N, index, heads):
    y = dt.new_empty((B, S, H, P))
    hT = torch.empty_like(h0)
    ws = dt.new_empty(B * -(-S // CHUNK) * H * (P * N + 1))
    err = cuda_entry("mamba_scan_heads_chunked")(
        DTYPE_CODE[x.dtype], DTYPE_CODE[h0.dtype], N, dt.data_ptr(),
        A.data_ptr(), x.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
        h0.data_ptr(), y.data_ptr(), hT.data_ptr(), ws.data_ptr(), B, S, H,
        P, heads, torch._C._cuda_getCurrentRawStream(index))
    check_launch("mamba_scan_heads_chunked", err)
    return y, hT


def launch_scan_heads_chunked(dt, A, x, Bc, Cc, h0, heads: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The head-shared form's chunked route on checked CUDA tensors (P 64,
    any S >= 1) with ``heads`` heads a chunk CTA (1..8) -> (y, hT).
    Counts nothing, as ``launch_scan_heads``."""
    B, S, H, P, N, index = check_cuda_args_heads(dt, A, x, Bc, Cc, h0)
    if P != CHUNKED_HEAD_DIM:
        raise ValueError(f"mamba_scan_heads chunked route: head dim {P}, "
                         f"want {CHUNKED_HEAD_DIM}")
    return _launch_chunked(dt, A, x, Bc, Cc, h0, B, S, H, P, N, index,
                           heads)


def mamba_scan_heads(dt: torch.Tensor, A: torch.Tensor, x: torch.Tensor,
                     Bc: torch.Tensor, Cc: torch.Tensor, h0: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K11, the head-shared (Mamba-2) form: -> (y (B, S, H, P) fp32, hT
    (B, H, P, N) in h0.dtype).

    CPU tensors run ``ref.scan_heads`` (meta ones ``k11_scan_heads``);
    CUDA tensors launch the Hopper kernels on the current stream, the
    route ``body`` names: the chunked scan on the tensor cores,
    ``chunk_heads`` heads a chunk CTA; or a thread a channel, time in
    ``scan_parts`` chunks (one launch on the count either way)."""
    if dt.device.type == "cpu":
        return scan_heads(dt, A, x, Bc, Cc, h0)
    if dt.is_meta:
        return torch.ops.repro_torch.k11_scan_heads(dt, A, x, Bc, Cc, h0)
    B, S, H, P, N, index = check_cuda_args_heads(dt, A, x, Bc, Cc, h0)
    code, h0_code = DTYPE_CODE[x.dtype], DTYPE_CODE[h0.dtype]
    if body(S, P, N) == "ssd":
        out = _launch_chunked(dt, A, x, Bc, Cc, h0, B, S, H, P, N, index,
                              chunk_heads(code, h0_code, N, B, S, H, index))
    else:
        parts = scan_parts(code, h0_code, N, B, S, H * P, index,
                           "mamba_scan_heads_resources")
        out = _launch_heads(dt, A, x, Bc, Cc, h0, B, S, H, P, N, index,
                            parts)
    count_launch(mamba_scan_heads)
    return out


mamba_scan_heads.launches = 0


class _MambaScan(torch.autograd.Function):
    """K11's model form forward; the backward is ``ref.scan_model_grads``,
    which recomputes the states from the inputs ``ref.BWD_CHUNK`` steps at
    a time (never from the forward's outputs)."""

    @staticmethod
    def forward(ctx, dt, A, x, Bc, Cc, h0):
        ctx.save_for_backward(dt, A, x, Bc, Cc, h0)
        return mamba_scan_model(dt, A, x, Bc, Cc, h0)

    @staticmethod
    def backward(ctx, g_y, g_hT):
        ins = ctx.saved_tensors
        grads = scan_model_grads(*ins, g_y, g_hT)
        return tuple(g.to(t.dtype) for g, t in zip(grads, ins))


def mamba1_scan(dt: torch.Tensor, A: torch.Tensor, x: torch.Tensor,
                Bc: torch.Tensor, Cc: torch.Tensor, h0: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selective scan of ``apply_mamba1``, differentiable: dt and x
    (B, S, E), A (E, N) fp32, Bc and Cc (B, S, N), h0 (B, E, N) -> (y, hT)
    in fp32."""
    return _MambaScan.apply(dt.contiguous(), A.contiguous(), x.contiguous(),
                            Bc.contiguous(), Cc.contiguous(),
                            h0.contiguous())


class _MambaScanHeads(torch.autograd.Function):
    """K11's head-shared forward; the backward is ``ref.scan_heads_grads``
    (the chunked form recomputed from the inputs and differentiated).  An
    output that reaches no loss gives None, and is not differentiated."""

    @staticmethod
    def forward(ctx, dt, A, x, Bc, Cc, h0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(dt, A, x, Bc, Cc, h0)
        return mamba_scan_heads(dt, A, x, Bc, Cc, h0)

    @staticmethod
    def backward(ctx, g_y, g_hT):
        ins = ctx.saved_tensors
        grads = scan_heads_grads(*ins, g_y, g_hT)
        return tuple(g.to(t.dtype) for g, t in zip(grads, ins))


def mamba2_scan(dt: torch.Tensor, A: torch.Tensor, x: torch.Tensor,
                Bc: torch.Tensor, Cc: torch.Tensor, h0: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The head-shared scan of ``apply_mamba2``, differentiable: dt (B, S,
    H) and A (H,) fp32, x (B, S, H·P), Bc and Cc (B, S, N), h0 (B, H, P, N)
    -> (y (B, S, H, P) fp32, hT in h0's dtype).  Where grad mode is off or
    no input requires a gradient it is ``mamba_scan_heads`` itself."""
    args = tuple(t.contiguous() for t in (dt, A, x, Bc, Cc, h0))
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _MambaScanHeads.apply(*args)
    return mamba_scan_heads(*args)
