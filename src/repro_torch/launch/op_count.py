"""Operation and byte counts of a step as it runs — the port's
counterpart of the reference's ``launch.hlo_parse``.

The reference parses the compiled per-partition HLO, because
``cost_analysis()`` counts a ``lax.scan`` body once, and walks every
while body times its trip count. The port has no HLO and no scan: its
layers run in a Python loop, eagerly, so every operation is seen as
often as it runs and the trip-count problem does not arise. ``OpCount``
is a ``TorchDispatchMode`` that counts each aten operation of whatever
runs under it, on ``meta`` (the dry run: shapes, no storage) or on the
card:

* flops — the products, as ``hlo_parse._dot_flops`` counts a dot:
  2·|out|·|contracted| for ``mm``, ``addmm``, ``bmm``, ``baddbmm``,
  ``mv``, ``addmv``, ``dot`` (``einsum`` and ``matmul`` reach these) and
  convolutions (forward, and each gradient a convolution's backward
  computes);
* bytes — each operation's tensor operands read plus its outputs
  written, at their logical sizes; views and metadata or allocation
  operations (``_BYTES_SKIP``) move none, as ``hlo_parse._BYTES_SKIP``
  skips bitcasts, tuples and parameters;
* peak live bytes — storages created under the mode are added when made
  and taken off when their last tensor is freed; storages that existed
  before (the step's arguments) are not counted.

The attention kernel is counted as the card runs it: ``flash_attention``
tells its observers (``kernels.flash_attention.ops.observers``) each
forward and backward call's work, the products of the visible pairs
alone (``ops.work``), on the card where it launches and on ``meta``
where ``MetaFlashFn`` stands in for it; the plain route's full S × S
products never run there. ``rows`` keeps each (operation, operand
shapes) with its count, flops and bytes, which ``inspect_cell`` ranks.

On ``meta`` an operation's output is a function of its operands'
metadata (shape, strides, dtype) and its other arguments alone, and the
meta kernels' Python shape rules cost far more than the counting. So an
out-of-place operation on ``meta`` tensors (no argument written, one
fresh tensor returned) is run once for each such key; a repeat makes its
output with ``empty_strided`` from the kept metadata (``_meta_out``).
The layers, microbatches and optimizer leaves of a step repeat their
operations many times over, so a traced step runs few meta kernels.
``memoize`` goes one level up, for a whole function (a microbatch's
``loss_and_grads``): a repeat call on the same metadata adds the first
call's counts again and makes its outputs, without running it.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten

from repro_torch.kernels.flash_attention import ops as flash_ops

aten = torch.ops.aten

# operations whose first tensor operand is (…, M, K) and whose output's
# every element contracts K of it; addmm / baddbmm / addmv carry a bias
# first
_PRODUCTS = {aten.mm.default: 0, aten.bmm.default: 0, aten.mv.default: 0,
             aten.addmm.default: 1, aten.baddbmm.default: 1,
             aten.addmv.default: 1}
_BYTES_SKIP = {
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "detach", "alias", "lift_fresh", "set_",
    "resize_", "_local_scalar_dense", "sym_size", "sym_stride",
    "sym_numel", "sym_storage_offset", "is_same_size", "scalar_tensor",
}


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def op_flops(func, args, out) -> int:
    """The products' operations of one aten call (0 for any other)."""
    packet = func.overloadpacket
    if func in _PRODUCTS:
        a = args[_PRODUCTS[func]]
        return 2 * out.numel() * a.shape[-1]
    if packet is aten.dot:
        return 2 * args[0].numel()
    if packet is aten.convolution:
        w = args[1]
        return 2 * out.numel() * (w.numel() // w.shape[0])
    if packet is aten.convolution_backward:
        # (grad_out, input, weight, ..., output_mask): each of grad_input
        # and grad_weight is one product of the forward's size
        grad_out, w, mask = args[0], args[2], args[-1]
        per = 2 * grad_out.numel() * (w.numel() // w.shape[0])
        return per * sum(bool(m) for m in mask[:2])
    return 0


def _key(x):
    """A hashable stand-in of one argument for ``_meta_out``'s key."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(map(_key, x))
    if isinstance(x, dict):
        return tuple((k, _key(v)) for k, v in sorted(x.items()))
    return x


def _on_meta(ins) -> bool:
    return bool(ins) and all(t.device.type == "meta" for t in ins)


def _cacheable(func) -> bool:
    schema = func._schema
    return (not schema.is_mutable and len(schema.returns) == 1
            and schema.returns[0].alias_info is None
            and str(schema.returns[0].type) == "Tensor")


class OpCount(TorchDispatchMode):
    """Counts flops, bytes and peak live bytes of what runs under it;
    ``rows`` maps (operation, operand shapes) to [count, flops, bytes]."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.rows: dict = {}
        self._live: dict = {}  # storage key → [nbytes, tracked tensors]
        self._meta: dict = {}  # (op, argument keys) → (shape, stride, dtype)

    def __enter__(self):
        flash_ops.observers.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        flash_ops.observers.remove(self)
        return super().__exit__(*exc)

    def _add(self, key, flops, nbytes):
        self._add_many(key, 1, flops, nbytes)

    def kernel(self, name, flops, nbytes, shapes):
        """A hand-written kernel's call (``flash_ops.observers``)."""
        self._add((name, shapes), flops, nbytes)

    def _release(self, key):
        rec = self._live.get(key)
        if rec is None:
            return
        rec[1] -= 1
        if rec[1] == 0:
            self.live_bytes -= rec[0]
            del self._live[key]

    def _track(self, outs, in_keys):
        for t in outs:
            key = t.untyped_storage()._cdata
            rec = self._live.get(key)
            if rec is None:
                if key in in_keys:  # aliases a storage made before the mode
                    continue
                rec = self._live[key] = [t.untyped_storage().nbytes(), 0]
                self.live_bytes += rec[0]
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            rec[1] += 1
            weakref.finalize(t, self._release, key).atexit = False

    def _meta_out(self, func, args, kwargs, ins):
        """``func``'s output on meta operands, from the metadata kept for
        the same call (run once when new); None where not cacheable."""
        if not _on_meta(ins) or not _cacheable(func):
            return None
        try:
            key = (func, _key(args), _key(kwargs))
            meta = self._meta.get(key)
        except TypeError:  # an unhashable argument
            return None
        if meta is None:
            out = func(*args, **kwargs)
            self._meta[key] = (tuple(out.shape), out.stride(), out.dtype)
            return out
        return torch.empty_strided(meta[0], meta[1], dtype=meta[2],
                                   device="meta")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        out = self._meta_out(func, args, kwargs, ins)
        if out is None:
            out = func(*args, **kwargs)
        outs = _tensors(out)
        name = func.overloadpacket.__name__
        if func.is_view or name in _BYTES_SKIP:
            nbytes = 0
        else:
            nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        flops = op_flops(func, args, out) if outs else 0
        self._add((name, tuple(tuple(t.shape) for t in ins[:3])), flops,
                  nbytes)
        self._track(outs, {t.untyped_storage()._cdata for t in ins})
        return out

    def memoize(self, fn):
        """``fn`` run once for each metadata of its (all-``meta``)
        arguments: a repeat adds the first run's rows, flops and bytes
        again, its peak of live bytes above the live bytes at the call,
        and returns outputs of the first run's metadata. On other devices
        ``fn`` just runs."""
        memo = {}

        def wrapper(*args, **kwargs):
            if not _on_meta(_tensors((args, kwargs))):
                return fn(*args, **kwargs)
            key = (_key(args), _key(kwargs))
            live0 = self.live_bytes
            if key in memo:
                delta, rel_peak, spec, metas = memo[key]
                for k, d in delta.items():
                    self._add_many(k, *d)
                self.peak_bytes = max(self.peak_bytes, live0 + rel_peak)
                with _disable_current_modes():
                    outs = [torch.empty_strided(*m[:2], dtype=m[2],
                                                device="meta") for m in metas]
                self._track(outs, set())
                return tree_unflatten(outs, spec)
            before = {k: list(v) for k, v in self.rows.items()}
            peak0, self.peak_bytes = self.peak_bytes, live0
            out = fn(*args, **kwargs)
            rel_peak = self.peak_bytes - live0
            self.peak_bytes = max(peak0, self.peak_bytes)
            delta = {k: [a - b for a, b in zip(v, before.get(k, (0, 0, 0)))]
                     for k, v in self.rows.items()}
            flat, spec = tree_flatten(out)
            memo[key] = ({k: d for k, d in delta.items() if d[0]}, rel_peak,
                         spec, [(tuple(t.shape), t.stride(), t.dtype)
                                for t in flat])
            return out

        return wrapper

    def _add_many(self, key, count, flops, nbytes):
        row = self.rows.setdefault(key, [0, 0, 0])
        row[0] += count
        row[1] += flops
        row[2] += nbytes
        self.flops += flops
        self.bytes += nbytes

    def summary(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "peak_live_bytes": self.peak_bytes,
                "operations": sum(r[0] for r in self.rows.values())}

    def top(self, by: str = "bytes", n: int = 25) -> list:
        """The ``n`` largest rows by ``by`` ("bytes" or "flops"): (name,
        operand shapes, count, flops, bytes)."""
        col = {"flops": 1, "bytes": 2}[by]
        rows = sorted(self.rows.items(), key=lambda kv: -kv[1][col])
        return [(k[0], k[1], *v) for k, v in rows[:n]]
