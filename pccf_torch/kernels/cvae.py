"""The counterfactual CVAE chain: weight pack, plain version and the CUDA
chain of ``csrc/cvae_cf.cu``.

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
wrapper derives its transposed, padded operands from it once.
"""

from __future__ import annotations

import dataclasses

import torch

from pccf_torch.kernels import _build, ops

LN_EPS = 1e-6
IN_PAD = 32  # token width padded to one GEMM k tile
OUT_PAD = 64  # compress head padded to one GEMM n tile


@dataclasses.dataclass
class CVAEPack:
    """Folded float32 weights of the chain, ``x · W`` layouts ``(in, out)``."""

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
    _cuda: dict | None = dataclasses.field(default=None, repr=False)

    def cuda_operands(self) -> dict:
        """Weights as ``(out, in)`` contiguous fp32 for the GEMM kernel, built
        on first use; token input and compress head zero-padded."""
        if self._cuda is None:
            def t(w):  # (in, out) -> (out, in)
                return w.detach().T.contiguous()

            def pad_in(w):  # (e, d) -> (d, IN_PAD)
                out = torch.zeros(w.shape[1], IN_PAD, dtype=w.dtype, device=w.device)
                out[:, : w.shape[0]] = w.T
                return out

            def layers(ps):
                return [{k: (t(v) if v.dim() == 2 else v.detach().contiguous()) for k, v in p.items()} for p in ps]

            e = self.wcomp.shape[1]
            wcomp = torch.zeros(OUT_PAD, self.wcomp.shape[0], dtype=self.wcomp.dtype, device=self.wcomp.device)
            wcomp[:e] = self.wcomp.T
            bcomp = torch.zeros(OUT_PAD, dtype=self.bcomp.dtype, device=self.bcomp.device)
            bcomp[:e] = self.bcomp
            self._cuda = {
                'win1': pad_in(self.win1), 'add1': self.add1.contiguous(), 'enc1': layers(self.enc1),
                'aw': t(self.aw), 'ab': self.ab.contiguous(),
                'win2': pad_in(self.win2), 'enc2': layers(self.enc2),
                'bw': t(self.bw), 'dec': layers(self.dec), 'wcomp': wcomp, 'bcomp': bcomp,
            }
        return self._cuda


def _lin(linear: torch.nn.Linear) -> tuple[torch.Tensor, torch.Tensor]:
    """``(W (in, out), b)`` of a torch Linear."""
    return linear.weight.detach().T, linear.bias.detach()


def _attn_qkv(attn) -> tuple[torch.Tensor, torch.Tensor]:
    ws, bs = zip(*(_lin(getattr(attn, n)) for n in ('query', 'key', 'value')))
    return torch.cat(ws, dim=1), torch.cat(bs)


def _ff(layer) -> dict:
    w1, b1 = _lin(layer.dense_0)
    w2, b2 = _lin(layer.dense_1)
    return {'w1': w1, 'b1': b1, 'w2': w2, 'b2': b2}


def _ln(norm, name: str) -> dict:
    return {f'{name}_w': norm.weight.detach(), f'{name}_b': norm.bias.detach()}


def pack_encoder_layer(layer) -> dict:
    w_qkv, b_qkv = _attn_qkv(layer.attn_0)
    w_o, b_o = _lin(layer.attn_0.out)
    return {**_ln(layer.norm_0, 'ln1'), 'w_qkv': w_qkv, 'b_qkv': b_qkv, 'w_o': w_o, 'b_o': b_o,
            **_ln(layer.norm_1, 'ln2'), **_ff(layer)}


def pack_decoder_layer(layer) -> dict:
    w_qkv, b_qkv = _attn_qkv(layer.attn_0)
    w_o, b_o = _lin(layer.attn_0.out)
    xw_q, xb_q = _lin(layer.attn_1.query)
    (wk, bk), (wv, bv) = _lin(layer.attn_1.key), _lin(layer.attn_1.value)
    xw_o, xb_o = _lin(layer.attn_1.out)
    return {**_ln(layer.norm_0, 'ln1'), 'w_qkv': w_qkv, 'b_qkv': b_qkv, 'w_o': w_o, 'b_o': b_o,
            **_ln(layer.norm_1, 'lnx'), 'xw_q': xw_q, 'xb_q': xb_q,
            'xw_kv': torch.cat([wk, wv], dim=1), 'xb_kv': torch.cat([bk, bv]), 'xw_o': xw_o, 'xb_o': xb_o,
            **_ln(layer.norm_2, 'ln2'), **_ff(layer)}


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
    return CVAEPack(
        win1=win1, add1=add1, enc1=[pack_encoder_layer(lyr) for lyr in enc.layers],
        aw=aw, ab=ab, win2=win2, add2=add2, enc2=[pack_encoder_layer(lyr) for lyr in post.layers],
        bw=bw, addd=addd, dec=[pack_decoder_layer(lyr) for lyr in dec.layers],
        wcomp=wcomp, bcomp=bcomp, prior_z2p=prior_z2p, wp=wp, bp=bp,
        heads=(enc.n_heads, post.n_heads, dec.n_heads),
    )


plain = ops.cvae_cf


def cvae_cf_cuda(x: torch.Tensor, probs: torch.Tensor, pack: CVAEPack) -> torch.Tensor:
    """``x (B, T, e)``, ``probs (B, C)`` float32 on the card -> ``(B, T, e)``.

    The guards of ``pccf_gemm`` and ``pccf_attention`` state the shapes the
    chain covers (64-row tiles over tokens, 64-wide heads, 64-multiple widths,
    at most 256 keys); this wrapper checks only what it lays out itself."""
    _build.require(x, 'x', torch.float32)
    if x.dim() != 3:
        raise ValueError(f'x: expected (B, T, e), got {tuple(x.shape)}')
    b, t, e = x.shape
    d = pack.aw.shape[0]
    _build.require(probs, 'probs', torch.float32, (b, pack.wp.shape[0]))
    if pack.add1.shape[0] != t or e > min(IN_PAD, OUT_PAD) or any(d % h for h in pack.heads):
        raise ValueError(f'cvae_cf: tokens {tuple(x.shape)} do not fit a pack of T={pack.add1.shape[0]}, d={d}, '
                         f'heads={pack.heads} (token width at most {min(IN_PAD, OUT_PAD)})')
    w = pack.cuda_operands()
    ffn = tuple(p['w1'].shape[1] for p in (*pack.enc1, *pack.enc2, *pack.dec))
    if w['aw'].device != x.device:
        raise ValueError(f'cvae_cf: weights on {w["aw"].device}, inputs on {x.device}')
    lib, stream = _build.lib(), _build.stream()
    m = b * t
    h1, h2, hd = pack.heads

    def gemm(a, wt, bias, res, out, res_rows=0, gelu=False):
        n, k = wt.shape
        err = lib.pccf_gemm(a.data_ptr(), wt.data_ptr(), bias.data_ptr() if bias is not None else None,
                            res.data_ptr() if res is not None else None, out.data_ptr(),
                            m, n, k, res_rows or m, int(gelu), stream)
        _build.check('pccf_gemm', err, f'M={m}, N={n}, K={k}')

    def norm(src, wgt, bias, out):
        err = lib.pccf_layer_norm(src.data_ptr(), wgt.data_ptr(), bias.data_ptr(), out.data_ptr(), m, d, LN_EPS,
                                  stream)
        _build.check('pccf_layer_norm', err, f'rows={m}, d={d}')

    def attend(q, q_stride, k, v, kv_stride, out, n_heads):
        err = lib.pccf_attention(q, q_stride, k, v, kv_stride, out.data_ptr(), d, b, t, t, n_heads, d // n_heads,
                                 stream)
        _build.check('pccf_attention', err, f'B={b}, T={t}, {n_heads} heads of {d // n_heads}')

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=x.device)

    res, h, att = empty(m, d), empty(m, d), empty(m, d)
    qkv = empty(m, 3 * d)
    ff_store = empty(m * max(ffn))
    off = d * 4  # bytes per d floats

    def ff_block(p):
        norm(res, p['ln2_w'], p['ln2_b'], h)
        f = ff_store[: m * p['w1'].shape[0]].view(m, -1)
        gemm(h, p['w1'], p['b1'], None, f, gelu=True)
        gemm(f, p['w2'], p['b2'], res, res)

    def self_attention(p, n_heads):
        norm(res, p['ln1_w'], p['ln1_b'], h)
        gemm(h, p['w_qkv'], p['b_qkv'], None, qkv)
        base = qkv.data_ptr()
        attend(base, 3 * d, base + off, base + 2 * off, 3 * d, att, n_heads)
        gemm(att, p['w_o'], p['b_o'], res, res)

    def encoder_stack(layers, n_heads):
        for p in layers:
            self_attention(p, n_heads)
            ff_block(p)

    x_pad = torch.zeros(m, IN_PAD, dtype=torch.float32, device=x.device)
    x_pad[:, :e] = x.reshape(m, e)
    pemb = torch.matmul(probs, pack.wp) + pack.bp
    pz2p = torch.einsum('bc,ctd->btd', probs, pack.prior_z2p)
    extra2 = (pack.add2 + pemb[:, None, :]).reshape(m, d).contiguous()
    extrad = (pack.addd + pz2p).reshape(m, d).contiguous()

    gemm(x_pad, w['win1'], None, w['add1'], res, res_rows=t)
    encoder_stack(w['enc1'], h1)
    memory = empty(m, d)
    gemm(res, w['aw'], None, w['ab'], memory, res_rows=t)

    gemm(x_pad, w['win2'], None, extra2, res)
    encoder_stack(w['enc2'], h2)
    dec_in = empty(m, d)
    gemm(res, w['bw'], None, extrad, dec_in)
    res = dec_in

    q, kv = empty(m, d), empty(m, 2 * d)
    for p in w['dec']:
        self_attention(p, hd)
        norm(res, p['lnx_w'], p['lnx_b'], h)
        gemm(h, p['xw_q'], p['xb_q'], None, q)
        gemm(memory, p['xw_kv'], p['xb_kv'], None, kv)
        attend(q.data_ptr(), d, kv.data_ptr(), kv.data_ptr() + off, 2 * d, att, hd)
        gemm(att, p['xw_o'], p['xb_o'], res, res)
        ff_block(p)

    out = empty(m, OUT_PAD)
    gemm(res, w['wcomp'], w['bcomp'], None, out)
    cvae_cf_cuda.launches += 1
    return out[:, :e].reshape(b, t, e)


cvae_cf_cuda.launches = 0
