"""Build and load the port's hand-written CUDA kernels.

Each ``.cu`` source under ``repro_torch/csrc`` (with the ``.cuh`` headers
the sources share) is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface and loaded with
``ctypes``.  The build happens at first use, from the repository's sources
only, into ``build/`` at the repository root; the library's file name
carries a hash of the source and the flags, so a second run (or a second
process) loads the cached build instead of compiling again.  Nothing here
runs at import time: the CPU tests import every module without a compiler.

``ENTRIES`` lists every C entry point of every library with its argument
types; ``cuda_entry(name)`` is the loaded function and ``LIBRARIES`` the
sources ``build_all`` compiles.  ``key_split`` sizes the key-range split of
the tensor-core attention tiles (``csrc/mma_tile.cuh``, bf16 K2 and K8, and
K4's in ``csrc/paged_mla.cu``; ``csrc/tf32_tile.cuh``, fp32 K8) and
allocates its workspace (K1 and K3 size their own decode splits).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}   # the kernels' dtype arg

_I, _P, _F = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
# entry point -> (csrc library, argument types)
ENTRIES = {
    # K1: dtype, d, bs, q, k_pool, v_pool, tables, seq_lens, out, B, KVH,
    # G, mb, window, softcap, scale, parts, workspace, stream
    "paged_decode_gqa": ("paged_attention",
                         [_I] * 3 + [_P] * 6 + [_I] * 5 + [_F, _F, _I, _P,
                                                           _P]),
    # K1's split-KV body: dtype, d, bs -> registers, spill bytes, shared
    # memory, CTAs an SM, query rows a CTA
    "paged_decode_gqa_resources": ("paged_attention", [_I] * 3 + [_P]),
    # K2: dtype, d, bs, q, k_pool, v_pool, tables, starts, out, B, KVH,
    # SG, G, mb, window, softcap, scale, parts, workspace, stream
    "paged_prefill_gqa": ("paged_attention",
                          [_I] * 3 + [_P] * 6 + [_I] * 6 + [_F, _F, _I, _P,
                                                            _P]),
    # K2's bf16 tile: d, bs -> registers, spill bytes, shared memory, CTAs
    # an SM, rows a CTA
    "paged_prefill_gqa_resources": ("paged_attention", [_I] * 2 + [_P]),
    # K3: dtype, lora, rope, bs, q_lat, q_rope, c_pool, kr_pool, tables,
    # seq_lens, out, B, H, mb, scale, parts, workspace, stream
    "paged_decode_mla": ("paged_mla",
                         [_I] * 4 + [_P] * 7 + [_I] * 3 + [_F, _I, _P, _P]),
    # K4: dtype, lora, rope, bs, q_lat, q_rope, c_pool, kr_pool, tables,
    # starts, out, B, SH, H, mb, scale, parts, workspace, stream
    "paged_prefill_mla": ("paged_mla",
                          [_I] * 4 + [_P] * 7 + [_I] * 4 + [_F, _I, _P, _P]),
    # K3's and K4's body (dtype 0: the fp32 SIMT body, 1: the bf16 tile),
    # lora, rope -> registers, spill bytes, shared memory, CTAs an SM, rows
    # a CTA
    "paged_mla_resources": ("paged_mla", [_I] * 3 + [_P]),
    "paged_indexer_scores": ("paged_indexer",
                             [_I] * 3 + [_P] * 6 + [_I] * 3 + [_F, _P]),
    "paged_prefill_indexer": ("paged_indexer",
                              [_I] * 3 + [_P] * 6 + [_I] * 4 + [_F, _P]),
    # the SIMT tile (fp32 K5 and K6, other head counts): dtype, Di, Hi ->
    # registers, spill bytes, shared memory, CTAs an SM, tokens a CTA
    "paged_indexer_resources": ("paged_indexer", [_I] * 3 + [_P]),
    # K5's bf16 tensor-core decode body: Hi, Di -> as above (positions a
    # CTA in place of tokens)
    "paged_indexer_scores_resources": ("paged_indexer", [_I] * 2 + [_P]),
    # K6's bf16 tensor-core body: Hi, Di -> as above
    "paged_prefill_indexer_resources": ("paged_indexer", [_I] * 2 + [_P]),
    # K7: dtype, Di, q, w, k, out, B, S, T, Hi, scale, stream
    "lightning_indexer": ("lightning_indexer",
                          [_I] * 2 + [_P] * 4 + [_I] * 4 + [_F, _P]),
    # K7's tensor-core body (dtype 0: fp32 by 3xTF32, 1: bf16): dtype, Hi,
    # Di -> as K6's
    "lightning_indexer_resources": ("lightning_indexer", [_I] * 3 + [_P]),
    # K8: dtype, dqk, dv, q, k, v, block_idx, q_start, out, B, S, T, H,
    # KVH, block_size, nb, empty_mean, softcap, scale, parts, workspace,
    # stream
    "block_sparse_attention": ("block_sparse",
                               [_I] * 3 + [_P] * 6 + [_I] * 8
                               + [_F, _F, _I, _P, _P]),
    # K8's body: dtype (0: the fp32 3xTF32 tile, 1: the bf16 tile), dqk, dv
    # -> as K2's
    "block_sparse_resources": ("block_sparse", [_I] * 3 + [_P]),
    # K9: dtype, d, q, k, v, out, B, Sq, Sk, H, KVH, causal, window,
    # q_offset, softcap, scale, parts, workspace, stream
    "flash_attention": ("flash_attention",
                        [_I] * 2 + [_P] * 4 + [_I] * 8 + [_F, _F, _I, _P,
                                                          _P]),
    # K9's tile (dtype 0: the fp32 3xTF32 tile, 1: the bf16 tile), d -> as
    # K2's
    "flash_attention_resources": ("flash_attention", [_I] * 2 + [_P]),
    # K10: dtype, h, w, targets, mask, partials, loss, count, Tk, D, V,
    # softcap, stream
    "chunked_ce": ("chunked_ce", [_I] + [_P] * 7 + [_I] * 3 + [_F, _P]),
    # K10's tile (fp32: 3xTF32 on the tensor cores; bf16: SIMT): dtype ->
    # registers, spill bytes, shared memory, CTAs an SM, tokens a CTA
    "chunked_ce_resources": ("chunked_ce", [_I] + [_P]),
    # K11 model form: dtype, h0 dtype, N, dt, A, x, Bc, Cc, h0, y, hT,
    # workspace, B, S, E, parts, stream
    "mamba_scan_model": ("mamba_scan", [_I] * 3 + [_P] * 9 + [_I] * 4 + [_P]),
    # K11's scan kernel: dtype, h0 dtype, N -> registers, spill bytes,
    # shared memory, CTAs an SM, channels a CTA
    "mamba_scan_model_resources": ("mamba_scan", [_I] * 3 + [_P]),
    # K11 head-shared (Mamba-2) form: dtype, h0 dtype, N, dt, A, x, Bc, Cc,
    # h0, y, hT, workspace, B, S, H, P, parts, stream
    "mamba_scan_heads": ("mamba_scan", [_I] * 3 + [_P] * 9 + [_I] * 5 + [_P]),
    # its scan kernel: dtype, h0 dtype, N -> as the model form's
    "mamba_scan_heads_resources": ("mamba_scan", [_I] * 3 + [_P]),
    # its chunked route on the tensor cores (P 64): dtype, h0 dtype, N, dt,
    # A, x, Bc, Cc, h0, y, hT, workspace, B, S, H, P, heads a CTA, stream
    "mamba_scan_heads_chunked": ("mamba_scan",
                                 [_I] * 3 + [_P] * 9 + [_I] * 5 + [_P]),
    # its kernels: dtype, h0 dtype, N, pass (1 the chunks' end states, 2
    # the fold, 3 y) -> as the model form's, the last the steps (passes 1,
    # 3) or states (pass 2) a CTA
    "mamba_scan_heads_chunked_resources": ("mamba_scan", [_I] * 4 + [_P]),
    # K11 contract: dtype, N, dA, dBx, C, h0, y, hT, B, S, E, stream
    "mamba_scan_contract": ("mamba_scan",
                            [_I] * 2 + [_P] * 6 + [_I] * 3 + [_P]),
}
LIBRARIES = sorted({lib for lib, _ in ENTRIES.values()})


def nvcc() -> str:
    """Path of ``nvcc``: PyTorch's idea of the CUDA home first, then PATH."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is not None and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit (set CUDA_HOME or put nvcc on "
                           "PATH)")
    return found


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` lives (hash of the source, the
    shared headers ``csrc/*.cuh`` it may include, and the flags)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its hashed build exists; returns
    the library path.  The compiler writes to a temporary file that is
    renamed into place, so a concurrent reader never sees half a file."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
           str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed building {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build if needed and ``dlopen`` ``csrc/<name>.cu``'s library once per
    process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(str(build(name)))
        return lib


def build_all(names: Sequence[str]) -> List[Path]:
    """Build several sources at once, one ``nvcc`` process each, all
    started together; returns their library paths in order."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return list(pool.map(build, names))


@functools.lru_cache(maxsize=None)
def cuda_entry(name: str):
    """The C entry point ``name`` of its kernel library, with its argument
    types declared (built at first use)."""
    lib, argtypes = ENTRIES[name]
    fn = getattr(load(lib), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def resources(query: str, *args: int) -> tuple:
    """(registers a thread, spill bytes a thread, shared memory bytes a CTA,
    CTAs resident on one SM, packed query rows a CTA) of the kernel that
    the C entry point ``query`` describes for ``args``, as the CUDA runtime
    reports them (cached: they do not change within a process)."""
    out = (ctypes.c_int * 5)()
    check_launch(query, cuda_entry(query)(*args, out))
    return tuple(out)


MAX_PARTS = 4   # key-range splits a tile takes (mma_tile.cuh, tf32_tile.cuh)


def key_split(query: str, args: Sequence[int], rows: int, others: int,
              dv: int, device: torch.device) -> tuple:
    """How a launch of a tensor-core attention tile fills the card:
    (parts, workspace).  ``rows`` packed query rows a (y, z) grid row,
    ``others`` grid rows, so ceil(rows / rows a CTA) * others tiles.  Each
    tile's key rounds are split over ``parts`` CTAs, as many as one wave of
    every CTA slot of the card holds (the CTAs an SM and the rows a CTA from
    the tile's resource query ``query`` for ``args``, times the SMs), at
    most ``MAX_PARTS``.  With parts > 1 the parts' (m, l, acc) go to the
    fp32 workspace returned here (tiles x parts x rows a CTA x (dv + 2)),
    folded by the kernel's combine pass; with 1 it is None."""
    parts, tiles, per_cta = _split(query, tuple(args), rows, others,
                                   device.index)
    if parts == 1:
        return 1, None
    return parts, torch.empty(tiles * parts * per_cta * (dv + 2),
                              dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=None)
def _split(query: str, args: tuple, rows: int, others: int,
           index: int) -> tuple:
    _, _, _, per_sm, per_cta = resources(query, *args)
    tiles = -(-rows // per_cta) * others
    slots = per_sm * torch.cuda.get_device_properties(index) \
        .multi_processor_count
    return max(1, min(MAX_PARTS, slots // tiles)), tiles, per_cta


_count_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one launch to ``wrapper.launches``.  Under a lock: the two serve
    threads of a disaggregated server launch the same wrappers at once, and
    ``+= 1`` on an attribute is a read and a write the GIL may split."""
    with _count_lock:
        wrapper.launches += 1


def check_launch(name: str, err: int) -> None:
    """Raise on the cudaError a kernel's C entry point returned."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def refuse_dtensor(name: str, *tensors) -> None:
    """Raise where a ``DTensor`` reaches a kernel's wrapper.  A wrapper
    hands raw pointers to its kernel, and a ``DTensor``'s pointer is its
    local shard's: a placed caller runs the wrapper on local shards
    (``sharding.rules.local_apply``), and no wrapper runs its plain version
    on one in its place."""
    from torch.distributed.tensor import DTensor
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{name}: a DTensor reached the kernel wrapper; "
                        f"call it on local shards")
