"""The counterfactual CVAE chain: weight pack, plain version and the CUDA
chain, which runs its three stacks through the stack launchers of
:mod:`pccf_torch.kernels.wformer` over ``csrc/wformer.cu``.

Replaces ``pccf/kernels/pallas_cvae.py:203`` ``cvae_cf_tpu`` and its pack
``pack_cvae_cf_params`` (``pallas_cvae.py:119-195``, built on
``pallas_wformer.py:244-328``).  The pack folds every head matmul of the
chain into its neighbour, as on the TPU:

- ``memory = h1 · (W_lat1[:, :z1] · W_z1) + (b_lat1[:z1] · W_z1 + b_z1 + mem_pos)``;
- the decoder input ``x = h2 · (W_lat2[:, :z2] · W_z2) + addd + pz2p`` where the
  conditional prior's mean enters as one ``(C, T, d)`` tensor ``prior_z2p``
  contracted with ``probs`` (``pz2p``) and its bias folds into ``addd``;
- the ``prob_proj`` row ``pemb = probs · W_p + b_p`` joins the posterior
  stack's input.

``pemb`` and ``pz2p`` are the tiny products outside the TPU kernel and stay
``torch.matmul`` here too.  The pack is built once per server; the CUDA
wrapper derives from it, once, a snapshot of every operand its GEMMs read:
the folds transposed and padded, copies of the stacks' layers, and the TF32
small part of each of their matrices.  The folds are a snapshot already, and
copying the layers keeps each matrix and its small part from drifting apart
if the live weights change.

Under the server's bf16 cast (:func:`pccf_torch.serve.bf16_copy`) the
stacks' matrices stay bfloat16 in the pack, as the parameters store them,
and so do the unfolded input projections and the compress head in the CUDA
snapshot (exactly: their values are bf16's); the GEMMs read them through
``pccf_gemm_bf16w``.  The folds are products, computed in float32 from the
rounded parameters, and stay float32.
"""

from __future__ import annotations

import dataclasses

import torch

from pccf_torch.kernels import _build, ops
from pccf_torch.kernels.wformer import Stacks, pack_decoder, pack_encoder, split_small, stack_weights

MAX_EMBEDDING = 128  # the widest token the chain takes (pallas_cvae.py:53 _IN_PAD)
IN_TILE = 32  # the token input is padded to whole GEMM k tiles
OUT_TILE = 64  # the compress head is padded to whole GEMM n tiles


def _pad(e: int, tile: int) -> int:
    return -(-e // tile) * tile


@dataclasses.dataclass
class CVAEPack:
    """Folded float32 weights of the chain, ``x · W`` layouts ``(in, out)``;
    the stacks' layers as :mod:`pccf_torch.kernels.wformer` packs them."""

    win1: torch.Tensor  # (e, d)
    add1: torch.Tensor  # (T, d)
    enc1: list[dict]
    aw: torch.Tensor  # (d, d)
    ab: torch.Tensor  # (T, d)
    win2: torch.Tensor  # (e, d)
    add2: torch.Tensor  # (T, d)
    enc2: list[dict]
    bw: torch.Tensor  # (d, d)
    addd: torch.Tensor  # (T, d)
    dec: list[dict]
    wcomp: torch.Tensor  # (d, e)
    bcomp: torch.Tensor  # (e,)
    prior_z2p: torch.Tensor  # (C, T, d)
    wp: torch.Tensor  # (C, d)
    bp: torch.Tensor  # (d,)
    heads: tuple[int, int, int]
    bf16: bool = False  # the stacks' matrices are bf16 (the server's cast)
    _cuda: dict | None = dataclasses.field(default=None, repr=False)
    # the pack as the cvae_cf op takes it (pccf_torch.kernels.library.cvae_tensors), built on first use
    _flat: tuple | None = dataclasses.field(default=None, repr=False)

    def cuda_operands(self) -> dict:
        """The folded weights as ``(out, in)`` contiguous fp32 for the GEMM
        kernel, built on first use, token input and compress head
        zero-padded (bf16 under the cast, the folds fp32); under ``'enc1'``,
        ``'enc2'`` and ``'dec'`` copies of the stacks' layers; under
        ``'weights'`` every matrix the GEMMs read, and under ``'small'`` the
        TF32 small parts of the fp32 ones
        (:func:`pccf_torch.kernels.wformer.split_small`)."""
        if self._cuda is None:
            def t(w):  # (in, out) -> (out, in)
                return w.detach().T.contiguous()

            e = self.wcomp.shape[1]
            stored = torch.bfloat16 if self.bf16 else self.wcomp.dtype

            def pad_in(w):  # (e, d) -> (d, e padded to IN_TILE)
                out = torch.zeros(w.shape[1], _pad(e, IN_TILE), dtype=stored, device=w.device)
                out[:, : w.shape[0]] = w.T
                return out

            out_pad = _pad(e, OUT_TILE)
            wcomp = torch.zeros(out_pad, self.wcomp.shape[0], dtype=stored, device=self.wcomp.device)
            wcomp[:e] = self.wcomp.T
            bcomp = torch.zeros(out_pad, dtype=self.bcomp.dtype, device=self.bcomp.device)
            bcomp[:e] = self.bcomp
            self._cuda = {
                'win1': pad_in(self.win1), 'add1': self.add1.contiguous(), 'aw': t(self.aw), 'ab': self.ab.contiguous(),
                'win2': pad_in(self.win2), 'bw': t(self.bw), 'wcomp': wcomp, 'bcomp': bcomp,
            }
            for name in ('enc1', 'enc2', 'dec'):
                self._cuda[name] = [{k: v.clone() for k, v in p.items()} for p in getattr(self, name)]
            weights = [self._cuda[name] for name in ('win1', 'aw', 'win2', 'bw', 'wcomp')]
            weights += stack_weights(self._cuda['enc1'] + self._cuda['enc2'] + self._cuda['dec'])
            self._cuda['weights'] = weights
            fp32 = [w for w in weights if w.dtype == torch.float32]
            self._cuda['small'] = split_small(fp32) if fp32 else {}
        return self._cuda


def _lin(linear: torch.nn.Linear) -> tuple[torch.Tensor, torch.Tensor]:
    """``(W (in, out), b)`` of a torch Linear, for the folds."""
    return linear.weight.detach().T, linear.bias.detach()


@torch.no_grad()
def pack_cvae_cf(wae) -> CVAEPack:
    """Fold a :class:`pccf_torch.models.w_autoencoders.WAutoEncoder`'s
    transformer nets into the chain's weights (``pallas_cvae.py:119-195``)."""
    enc, post, dec, prior = wae.encoder, wae.z2_posterior, wae.decoder, wae.z2_prior
    z1, z2 = wae.z1_dim, wae.z2_dim
    t = wae.n_codes

    win1, bin1 = _lin(enc.input_proj.dense)
    add1 = enc.positional_encoding[0] + bin1
    wlat1, blat1 = _lin(enc.to_latent.dense)
    wz1, bz1 = _lin(dec.z1_proj.dense)
    aw = wlat1[:, :z1] @ wz1
    ab = (blat1[:z1] @ wz1 + bz1)[None] + dec.memory_positional_embedding[0]

    win2, bin2 = _lin(post.input_proj.dense)
    add2 = post.positional_encoding[0] + bin2
    wlat2, blat2 = _lin(post.to_latent.dense)
    wz2, bz2 = _lin(dec.z2_proj.dense)
    bw = wlat2[:, :z2] @ wz2

    wprior, bprior = _lin(prior.prior.dense)  # (C, T * 2 z2)
    n_classes = wprior.shape[0]
    wprior_mu = wprior.reshape(n_classes, t, 2 * z2)[:, :, :z2]
    bprior_mu = bprior.reshape(t, 2 * z2)[:, :z2]
    prior_z2p = torch.einsum('ctz,zd->ctd', wprior_mu, wz2)
    addd = dec.positional_embedding[0] + (blat2[:z2] @ wz2 + bz2)[None] + bprior_mu @ wz2

    wcomp, bcomp = _lin(dec.compress.dense)
    wp, bp = _lin(post.prob_proj.dense)
    enc1, enc2, dec_layers = pack_encoder(enc.layers), pack_encoder(post.layers), pack_decoder(dec.layers)
    # the transposed weights stored as tensors of their own: an exported
    # program keeps each constant's storage, not a view into a parameter's
    return CVAEPack(
        win1=win1.contiguous(), add1=add1, enc1=enc1,
        aw=aw, ab=ab, win2=win2.contiguous(), add2=add2, enc2=enc2,
        bw=bw, addd=addd, dec=dec_layers,
        wcomp=wcomp.contiguous(), bcomp=bcomp, prior_z2p=prior_z2p, wp=wp.contiguous(), bp=bp,
        heads=(enc.n_heads, post.n_heads, dec.n_heads),
        bf16=any(w.dtype == torch.bfloat16 for w in stack_weights(enc1 + enc2 + dec_layers)),
    )


plain = ops.cvae_cf


def cvae_cf_cuda(x: torch.Tensor, probs: torch.Tensor, pack: CVAEPack) -> torch.Tensor:
    """``x (B, T, e)``, ``probs (B, C)`` float32 on the card -> ``(B, T, e)``.

    The guards of ``pccf_gemm`` and ``pccf_attention`` state the shapes the
    chain covers (64-row tiles over tokens, heads of any width, 64-multiple
    widths); this wrapper checks what it lays out itself and the heads, and
    raises ``ValueError`` before any launch."""
    _build.require(x, 'x', torch.float32)
    if x.dim() != 3:
        raise ValueError(f'x: expected (B, T, e), got {tuple(x.shape)}')
    b, t, e = x.shape
    d = pack.aw.shape[0]
    _build.require(probs, 'probs', torch.float32, (b, pack.wp.shape[0]))
    if pack.add1.shape[0] != t or e > MAX_EMBEDDING or e != pack.wcomp.shape[1] or any(d % h for h in pack.heads):
        raise ValueError(f'cvae_cf: tokens {tuple(x.shape)} do not fit a pack of T={pack.add1.shape[0]}, d={d}, '
                         f'heads={pack.heads} (token width at most {MAX_EMBEDDING})')
    w = pack.cuda_operands()
    if w['aw'].device != x.device:
        raise ValueError(f'cvae_cf: weights on {w["aw"].device}, inputs on {x.device}')
    m = b * t
    h1, h2, hd = pack.heads
    stacks = Stacks(b, t, d, x.device, w['small'])
    empty = stacks.empty

    x_pad = torch.zeros(m, w['win1'].shape[1], dtype=torch.float32, device=x.device)
    x_pad[:, :e] = x.reshape(m, e)
    pemb = torch.matmul(probs, pack.wp) + pack.bp
    pz2p = torch.einsum('bc,ctd->btd', probs, pack.prior_z2p)
    extra2 = (pack.add2 + pemb[:, None, :]).reshape(m, d).contiguous()
    extrad = (pack.addd + pz2p).reshape(m, d).contiguous()

    res = empty(m, d)
    stacks.gemm(x_pad, [w['win1']], [None], [res], w['add1'], res_rows=t)
    stacks.encoder(res, w['enc1'], h1)
    memory = empty(m, d)
    stacks.gemm(res, [w['aw']], [None], [memory], w['ab'], res_rows=t)

    stacks.gemm(x_pad, [w['win2']], [None], [res], extra2)
    stacks.encoder(res, w['enc2'], h2)
    dec_in = empty(m, d)
    stacks.gemm(res, [w['bw']], [None], [dec_in], extrad)
    stacks.decoder(dec_in, memory, w['dec'], hd)

    out = empty(m, w['wcomp'].shape[0])
    stacks.gemm(dec_in, [w['wcomp']], [w['bcomp']], [out])
    cvae_cf_cuda.launches += 1
    return out[:, :e].reshape(b, t, e)


cvae_cf_cuda.launches = 0
