"""Count a step's FLOPs, bytes, peak memory and collectives while it runs
on ``meta``.

The port's counterpart of ``repro.roofline.hlo_parse``.  The reference
parses the partitioned HLO because XLA's ``cost_analysis()`` counts a
loop's body once; eager PyTorch runs every iteration, so the port counts
each op as it is dispatched, with abstract tensors (no storage, no
compute):

* FLOPs of the matrix-product ops (``torch.utils.flop_counter``'s
  ``FlopCounterMode``: mm, bmm, addmm, baddbmm, convolution, attention),
  as the reference counts ``dot``s only;
* bytes: each op's tensor inputs read once and outputs written once; view
  ops (outputs that alias an input without writing it) move nothing, nor
  do the functional collectives' bookkeeping ops (waiting, wrapping);
* peak live bytes: every storage an op creates is alive until it is freed
  (held by a weak reference, so autograd's saved tensors count while the
  graph keeps them), to within 1 % (``PEAK_SLACK``); the step's arguments
  (parameters, optimizer state, batch, cache) are counted apart, as the
  reference's argument bytes;
* collectives: the functional collectives' ops (``_c10d_functional``),
  their buffer bytes and group sizes.

A kernel wrapper given ``meta`` tensors runs its plain version's ops, so
the bytes are those of the unfused eager program, where the reference's
are those of XLA's fusions: the record says so in ``bytes_kind``.  K11's
forwards are the exception: on ``meta`` each is one op (its plain
version steps through time in Python), counted as its kernel moves its
bytes (``kernels.mamba_scan.kernel``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.utils import leaves

BYTES_KIND = ("eager_unfused: each dispatched op's inputs read and outputs "
              "written once, the kernels' plain versions on meta but K11's "
              "forwards, one op each")

# the freed storages are looked for only when the bytes held (live and
# freed) pass the peak by this share of it: the peak is exact to it, and
# a loop that keeps each step's output (a scan stepping through time) does
# not look through every storage at every step
PEAK_SLACK = 0.01

# the functional collectives by the reference's HLO names
COLLECTIVES = {"all_reduce": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all"}


@dataclasses.dataclass
class Counts:
    flops: float
    bytes: float
    collectives: List[Tuple[str, int, int]]   # (op, buffer bytes, ranks)
    argument_bytes: int
    peak_bytes: int            # arguments + the most live bytes beside
    #                            them, to within PEAK_SLACK of the latter
    output_bytes: int          # returned storages that are not arguments


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storages(tree) -> Dict[int, int]:
    """{storage key: bytes} of the tensors of ``tree``."""
    out = {}
    for t in leaves(tree):
        st = t.untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class _Counter(TorchDispatchMode):
    """Bytes, live storages and collectives of every dispatched op."""

    def __init__(self, arguments: Dict[int, int]):
        super().__init__()
        self.arguments = arguments
        self.bytes = 0
        self.live: Dict[int, Tuple[StorageWeakRef, int]] = {}
        self.held = 0          # bytes of ``live``, some perhaps freed
        self.peak = 0
        self.collectives: List[Tuple[str, int, int]] = []

    def _prune(self) -> None:
        dead = [k for k, (ref, _) in self.live.items() if ref.expired()]
        for k in dead:
            self.held -= self.live.pop(k)[1]

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.arguments:
            return
        old = self.live.get(key)
        if old is not None:
            if not old[0].expired():
                return
            self.held -= old[1]        # a freed storage's address, reused
        self.live[key] = (StorageWeakRef(st), st.nbytes())
        self.held += st.nbytes()
        # the live bytes can pass the peak only if the held ones do
        if self.held > self.peak * (1 + PEAK_SLACK):
            self._prune()
            self.peak = max(self.peak, self.held)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        bookkeeping = False
        if func.namespace == "_c10d_functional":
            if name in COLLECTIVES:
                from torch.distributed.distributed_c10d import \
                    _resolve_process_group
                group = _resolve_process_group(args[-1]).size()
                self.collectives.append((COLLECTIVES[name], _nbytes(out),
                                         group))
            else:
                bookkeeping = True
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not (bookkeeping or _is_view(func)):
            self.bytes += sum(_nbytes(t) for t in tree_leaves((args, kwargs))
                              if isinstance(t, torch.Tensor))
            self.bytes += sum(_nbytes(t) for t in outs)
        for t in outs:
            self._track(t)
        return out


def count(fn: Callable, *args, arguments: Any = ()) -> Tuple[Any, Counts]:
    """Run ``fn(*args)`` (on ``meta`` tensors) under the counters;
    ``arguments`` is the tree of the step's inputs whose storages are its
    arguments.  Returns (fn's result, the counts)."""
    arg_st = _storages(arguments)
    counter = _Counter(arg_st)
    with FlopCounterMode(display=False) as flops, counter:
        out = fn(*args)
    counter._prune()
    counter.peak = max(counter.peak, counter.held)
    arg_bytes = sum(arg_st.values())
    outs = {k: v for k, v in _storages(out).items() if k not in arg_st}
    return out, Counts(flops=float(flops.get_total_flops()),
                       bytes=float(counter.bytes),
                       collectives=counter.collectives,
                       argument_bytes=arg_bytes,
                       peak_bytes=arg_bytes + counter.peak,
                       output_bytes=sum(outs.values()))
