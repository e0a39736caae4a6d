"""The serving kernels as ``torch.library`` custom ops, namespace ``pccf``.

Each op that the three serving endpoints (classify, counterfactual,
generate) reach is one ``torch.ops.pccf.*`` operator, defined on a
``torch.library.Library`` (its Python kernels cost the dispatcher less host
time a call than ``torch.library.custom_op``'s, which checks every
``Tensor[]`` element for aliasing).  Its CUDA implementation is the
hand-written kernel's wrapper, which counts its launches; its CPU
implementation is the plain version; its fake implementation states the
output's shape and type from the inputs' shapes alone, so ``torch.export``
traces through it on fake tensors with a symbolic batch.  PyTorch dispatches by the inputs' device: a CUDA tensor
launches the kernel (or the wrapper raises), a CPU tensor runs the plain
version, any other device has neither and raises.  The plans that read the
batch (``knn.splits``, ``graph_filter.filter_plan``, the pools' slice plan)
run inside the CUDA implementations, on real shapes.

A pack crosses the op boundary as a ``Tensor[]`` in a fixed order with its
int, float and bool fields beside it, and the op body rebuilds the pack
around those tensors.  An exported program holds the tensors as constants.
What a CUDA wrapper derives from a pack once (the CVAE chain's transposed
folds and TF32 small parts, PCGen's fp16 weights and operand bounds) is kept
on the pack object, so the op body must meet the same pack object again: an
eager call hands it its caller's pack (:func:`caller_pack`), and an exported
program's pack is built on its first call and kept with its constants
(:func:`pack_of`).

``graph_filter`` is used in training as well: its gradient is the
``graph_filter_backward`` op (the backward kernel and the row scatter in
their order) through ``register_autograd``.  The training-only kernels (the
row and slot scatters, the sum pool, the pool with its source, the loss
kernels, the auction) stay ``autograd.Function`` s: no endpoint exports them.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Iterator

import torch
from torch import Tensor

from pccf_torch.kernels import cvae as cvae_mod, gather, graph_filter as filter_mod, knn as knn_mod, pcgen as pcgen_mod
from pccf_torch.kernels import wformer as wformer_mod

# the names of a stack layer's tensors, in the order they cross the op boundary
ENCODER_KEYS = ('ln1_w', 'ln1_b', 'wq', 'bq', 'wk', 'bk', 'wv', 'bv', 'wo', 'bo',
                'ln2_w', 'ln2_b', 'w1', 'b1', 'w2', 'b2')
DECODER_KEYS = ('ln1_w', 'ln1_b', 'wq', 'bq', 'wk', 'bk', 'wv', 'bv', 'wo', 'bo',
                'lnx_w', 'lnx_b', 'wxq', 'bxq', 'wxk', 'bxk', 'wxv', 'bxv', 'wxo', 'bxo',
                'ln2_w', 'ln2_b', 'w1', 'b1', 'w2', 'b2')
# the CVAE chain's folded tensors, before its three stacks' layers
CVAE_FIELDS = ('win1', 'add1', 'aw', 'ab', 'win2', 'add2', 'bw', 'addd', 'wcomp', 'bcomp', 'prior_z2p', 'wp', 'bp')


_local = threading.local()  # .pack: (tensors, pack) of the eager call in flight on this thread


@contextlib.contextmanager
def caller_pack(tensors: list[Tensor], pack) -> Iterator[None]:
    """Within the block, an op body given ``tensors`` uses ``pack`` itself:
    the caller's (a server's prepacked pack, and what a wrapper has derived
    from it already), not one rebuilt around the tensors."""
    _local.pack = (tensors, pack)
    try:
        yield
    finally:
        _local.pack = None


def pack_of(tensors: list[Tensor], build: Callable[[], object]):
    """The pack of ``tensors`` in an op body: the caller's (:func:`caller_pack`)
    where it holds these tensors, else the one built around them on their
    first call and kept on the first tensor (an exported program's
    constants: built once for the program's life)."""
    held = getattr(_local, 'pack', None)
    if held is not None and len(held[0]) == len(tensors) and all(a is b for a, b in zip(held[0], tensors)):
        return held[1]
    key = tuple(map(id, tensors))
    cached = getattr(tensors[0], '_pccf_pack', None)
    if cached is None or cached[0] != key:  # the pack holds the tensors: ids equal means the same tensors
        cached = (key, build())
        tensors[0]._pccf_pack = cached
    return cached[1]


# called with (op name, output) after every kernel or plain version runs, where set
# (pccf_torch.utils.debug.enable_nan_debugging)
output_check: Callable[[str, object], None] | None = None


def _fresh(out: Tensor, *inputs: Tensor) -> Tensor:
    """``out`` contiguous and not one of ``inputs`` (an op's output never aliases its input)."""
    out = out.contiguous()
    return out.clone() if any(out is x for x in inputs) else out


def _checked(op: str, out):
    if output_check is not None:
        output_check(op, out)
    return out


# ---------------------------------------------------------------- packs


def stack_tensors(pack: list[dict], keys: tuple[str, ...]) -> list[Tensor]:
    """A stack's pack (:func:`pccf_torch.kernels.wformer.pack_encoder`) as one list, layer by layer."""
    for p in pack:
        if set(p) != set(keys):
            raise ValueError(f'a stack layer holds {sorted(p)}, expected {sorted(keys)}')
    return [p[k] for p in pack for k in keys]


def stack_pack(tensors: list[Tensor], keys: tuple[str, ...]) -> list[dict]:
    n = len(keys)
    if len(tensors) % n:
        raise ValueError(f'{len(tensors)} tensors are not whole layers of {n}')
    return [dict(zip(keys, tensors[i: i + n])) for i in range(0, len(tensors), n)]


def pcgen_tensors(pack: pcgen_mod.PCGenPack) -> list[Tensor]:
    """``map_w, map_b``, the component layers' weights then biases, ``head_w,
    head_b, att_w, att_b``."""
    return [pack.map_w, pack.map_b, *pack.layer_ws, *pack.layer_bs, pack.head_w, pack.head_b, pack.att_w, pack.att_b]


def pcgen_pack(tensors: list[Tensor]) -> pcgen_mod.PCGenPack:
    n = (len(tensors) - 6) // 2
    return pcgen_mod.PCGenPack(map_w=tensors[0], map_b=tensors[1], layer_ws=tuple(tensors[2: 2 + n]),
                               layer_bs=tuple(tensors[2 + n: 2 + 2 * n]), head_w=tensors[-4], head_b=tensors[-3],
                               att_w=tensors[-2], att_b=tensors[-1])


def cvae_tensors(pack: cvae_mod.CVAEPack) -> tuple[list[Tensor], list[int]]:
    """The chain's folded tensors (:data:`CVAE_FIELDS`) and its three stacks'
    layers, and the stacks' layer counts; flattened once a pack (a pack is a
    snapshot: its tensors are not replaced)."""
    if pack._flat is None:
        stacks = (stack_tensors(pack.enc1, ENCODER_KEYS), stack_tensors(pack.enc2, ENCODER_KEYS),
                  stack_tensors(pack.dec, DECODER_KEYS))
        pack._flat = ([getattr(pack, f) for f in CVAE_FIELDS] + [t for s in stacks for t in s],
                      [len(pack.enc1), len(pack.enc2), len(pack.dec)])
    return pack._flat


def cvae_pack(tensors: list[Tensor], layers: list[int], heads: list[int], bf16: bool) -> cvae_mod.CVAEPack:
    fields = dict(zip(CVAE_FIELDS, tensors))
    rest = tensors[len(CVAE_FIELDS):]
    n1, n2 = layers[0] * len(ENCODER_KEYS), layers[1] * len(ENCODER_KEYS)
    return cvae_mod.CVAEPack(**fields, enc1=stack_pack(rest[:n1], ENCODER_KEYS),
                             enc2=stack_pack(rest[n1: n1 + n2], ENCODER_KEYS),
                             dec=stack_pack(rest[n1 + n2:], DECODER_KEYS), heads=tuple(heads), bf16=bf16)


_lib = torch.library.Library('pccf', 'DEF')


def _define(schema: str, cuda: Callable, cpu: Callable, fake: Callable) -> torch._ops.OpOverload:
    """Define ``pccf::<schema>`` with its CUDA kernel (the hand-written
    kernel's wrapper), its CPU kernel (the plain version) and its fake."""
    name = schema.split('(')[0]
    _lib.define(schema)
    _lib.impl(name, cuda, 'CUDA')
    _lib.impl(name, cpu, 'CPU')
    torch.library.register_fake(f'pccf::{name}', fake, lib=_lib)
    return getattr(torch.ops.pccf, name).default


# ------------------------------------------------------------------ kNN


def _knn_cuda(x: Tensor, k: int) -> Tensor:
    return _checked('knn', knn_mod.knn_cuda(x, k))


def _knn_cpu(x: Tensor, k: int) -> Tensor:
    return _checked('knn', _fresh(knn_mod.plain(x, k)))


def _knn_fake(x: Tensor, k: int) -> Tensor:
    return x.new_empty((x.shape[0], x.shape[1], k), dtype=torch.int32)


# self-kNN indices (B, N, k) int32 (knn.knn_cuda)
knn = _define('knn(Tensor x, int k) -> Tensor', _knn_cuda, _knn_cpu, _knn_fake)


# ------------------------------------------------------- eval max-pool


def _pool_cuda(x: Tensor, idx: Tensor) -> Tensor:
    return _checked('graph_max_pool', gather.graph_max_pool_cuda(x, idx))


def _pool_cpu(x: Tensor, idx: Tensor) -> Tensor:
    return _checked('graph_max_pool', _fresh(gather.plain(x, idx), x))


def _pool_fake(x: Tensor, idx: Tensor) -> Tensor:
    return torch.empty_like(x, memory_format=torch.contiguous_format)


# the max over the gathered neighbours, eval (gather.graph_max_pool_cuda)
graph_max_pool = _define('graph_max_pool(Tensor x, Tensor idx) -> Tensor', _pool_cuda, _pool_cpu, _pool_fake)


# ------------------------------------------------------------ CVAE chain


def _cvae_cuda(x, probs, tensors, layers, heads, bf16):
    pack = pack_of(tensors, lambda: cvae_pack(tensors, layers, heads, bf16))
    return _checked('cvae_cf', _fresh(cvae_mod.cvae_cf_cuda(x, probs, pack)))


def _cvae_cpu(x, probs, tensors, layers, heads, bf16):
    return _checked('cvae_cf', _fresh(cvae_mod.plain(x, probs, cvae_pack(tensors, layers, heads, bf16)), x))


def _cvae_fake(x, probs, tensors, layers, heads, bf16):
    return x.new_empty(x.shape)


# the counterfactual CVAE chain (B, T, e) (cvae.cvae_cf_cuda) on the pack cvae_pack rebuilds
cvae_cf = _define('cvae_cf(Tensor x, Tensor probs, Tensor[] tensors, int[] layers, int[] heads, bool bf16) -> Tensor',
                  _cvae_cuda, _cvae_cpu, _cvae_fake)


# ----------------------------------------------------------------- PCGen


def _pcgen_cpu(name: str):
    def run(m, w, tensors, tau, act_slope):
        return _checked(name, _fresh(pcgen_mod.plain(m, w, pcgen_pack(tensors), tau=tau, act_slope=act_slope)))
    return run


def _pcgen_cuda(name: str, wrapper: Callable):
    def run(m, w, tensors, tau, act_slope):
        return _checked(name, wrapper(m, w, pack_of(tensors, lambda: pcgen_pack(tensors)), tau=tau,
                                      act_slope=act_slope))
    return run


def _pcgen_fake(m, w, tensors, tau, act_slope):
    return m.new_empty((m.shape[0], m.shape[1], 3))


_PCGEN = '(Tensor m, Tensor w, Tensor[] tensors, float tau, float act_slope) -> Tensor'
# PCGen's flagship kernel and its general one, (B, N, 3) (pcgen.pcgen_mix_cuda, pcgen.pcgen_general_cuda)
pcgen_mix = _define('pcgen_mix' + _PCGEN, _pcgen_cuda('pcgen_mix', pcgen_mod.pcgen_mix_cuda), _pcgen_cpu('pcgen_mix'),
                    _pcgen_fake)
pcgen_general = _define('pcgen_general' + _PCGEN, _pcgen_cuda('pcgen_general', pcgen_mod.pcgen_general_cuda),
                        _pcgen_cpu('pcgen_general'), _pcgen_fake)


# ------------------------------------------------------------ the stacks


def _encoder_cuda(x, tensors, n_heads):
    return _checked('wformer_encoder', wformer_mod.wformer_encoder_cuda(x, stack_pack(tensors, ENCODER_KEYS), n_heads))


def _encoder_cpu(x, tensors, n_heads):
    return _checked('wformer_encoder',
                    _fresh(wformer_mod.plain_encoder(x, stack_pack(tensors, ENCODER_KEYS), n_heads), x))


def _decoder_cuda(x, memory, tensors, n_heads):
    return _checked('wformer_decoder',
                    wformer_mod.wformer_decoder_cuda(x, memory, stack_pack(tensors, DECODER_KEYS), n_heads))


def _decoder_cpu(x, memory, tensors, n_heads):
    return _checked('wformer_decoder',
                    _fresh(wformer_mod.plain_decoder(x, memory, stack_pack(tensors, DECODER_KEYS), n_heads), x))


# pre-norm encoder and decoder stacks in eval (wformer.wformer_encoder_cuda, wformer.wformer_decoder_cuda)
wformer_encoder = _define('wformer_encoder(Tensor x, Tensor[] tensors, int n_heads) -> Tensor', _encoder_cuda,
                          _encoder_cpu, lambda x, tensors, n_heads: x.new_empty(x.shape))
wformer_decoder = _define('wformer_decoder(Tensor x, Tensor memory, Tensor[] tensors, int n_heads) -> Tensor',
                          _decoder_cuda, _decoder_cpu, lambda x, memory, tensors, n_heads: x.new_empty(x.shape))


# --------------------------------------------------------- graph filtering


def _filter_cuda(x: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    return _checked('graph_filter', filter_mod.graph_filter_cuda(x))


def _filter_cpu(x: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    out, idx, mean = filter_mod.plain(x)
    return _checked('graph_filter', (_fresh(out, x), _fresh(idx), _fresh(mean)))


def _filter_fake(x: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    b, n, _ = x.shape
    return x.new_empty(x.shape), x.new_empty((b, n, filter_mod.K), dtype=torch.int32), x.new_empty((b,))


def _filter_backward_cuda(x, idx, mean, g):
    return _checked('graph_filter_backward', filter_mod.graph_filter_backward_cuda(x, idx, mean, g))


def _filter_backward_cpu(x, idx, mean, g):
    return _checked('graph_filter_backward', _fresh(filter_mod.plain_backward(x, idx, mean, g), x, g))


# graph filtering's fused pass: out (B, N, 3), idx (B, N, 4) int32 and the mean
# slot-1 distance (B,) (graph_filter.graph_filter_cuda); its gradient, the
# backward kernel then the row scatter in ascending edge order
# (graph_filter.graph_filter_backward_cuda)
graph_filter = _define('graph_filter(Tensor x) -> (Tensor, Tensor, Tensor)', _filter_cuda, _filter_cpu,
                       _filter_fake)
graph_filter_backward = _define('graph_filter_backward(Tensor x, Tensor idx, Tensor mean, Tensor g) -> Tensor',
                                _filter_backward_cuda, _filter_backward_cpu,
                                lambda x, idx, mean, g: x.new_empty(x.shape))


def _filter_setup(ctx, inputs, output) -> None:
    _, idx, mean = output
    ctx.save_for_backward(inputs[0], idx, mean)
    ctx.mark_non_differentiable(idx, mean)


def _filter_backward(ctx, g, _g_idx, _g_mean):
    x, idx, mean = ctx.saved_tensors
    return graph_filter_backward(x, idx, mean, g.contiguous())


torch.library.register_autograd('pccf::graph_filter', _filter_backward, setup_context=_filter_setup, lib=_lib)

# every op of this module, by name
OPS = {'knn': knn, 'graph_max_pool': graph_max_pool, 'cvae_cf': cvae_cf, 'pcgen_mix': pcgen_mix,
       'pcgen_general': pcgen_general, 'wformer_encoder': wformer_encoder, 'wformer_decoder': wformer_decoder,
       'graph_filter': graph_filter, 'graph_filter_backward': graph_filter_backward}
