"""The work model behind ``bound_ms`` in ``chip_smoke.py``
(``pccf_torch.kernels.roofline``), on the CPU.

The stacks' operation counts against ``torch.utils.flop_counter`` over the
plain versions (every matrix product counted as 2·M·N·K, exactly), the
flagship stage-2 figures: 77.3 GFLOP for the W-encoder stack and 231.9 GFLOP
for the W-decoder stack at batch 32, both bound by operations; and the
per-launch counts of the stacks' GEMM and attention, summed over the
launches a stack issues (recorded by a stand-in for the kernel library),
against the stack's count.
"""

import ctypes

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from pccf_torch.kernels import _build, api, roofline, wformer

torch.set_num_threads(1)


def _pack(d, widths, decoder, device='cpu'):
    gen = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=gen).to(device) if device == 'cpu' else torch.empty(shape, device=device)

    layers = []
    for f in widths:
        p = {'ln1_w': r(d), 'ln1_b': r(d), 'ln2_w': r(d), 'ln2_b': r(d),
             'w1': r(f, d) / d, 'b1': r(f), 'w2': r(d, f) / f, 'b2': r(d)}
        for name in ('q', 'k', 'v', 'o', *(('xq', 'xk', 'xv', 'xo') if decoder else ())):
            p.update({f'w{name}': r(d, d) / d, f'b{name}': r(d)})
        if decoder:
            p.update({'lnx_w': r(d), 'lnx_b': r(d)})
        layers.append(p)
    return layers


@pytest.mark.parametrize('decoder', [False, True])
def test_stack_operations_match_the_flop_counter(decoder):
    """Mixed FF widths, and a memory shorter than the tokens."""
    pack = _pack(64, (128, 64), decoder)
    x, memory = torch.randn(2, 64, 64), torch.randn(2, 32, 64)
    with FlopCounterMode(display=False) as counter:
        if decoder:
            wformer.plain_decoder(x, memory, pack, 1)
        else:
            wformer.plain_encoder(x, pack, 1)
    work = roofline.decoder_stack_work(x, memory, pack) if decoder else roofline.encoder_stack_work(x, pack)
    assert work.ops == counter.get_total_flops()
    assert work.peak == roofline.TF32


class RecordingLib:
    """Stands in for the kernel library on the CPU: records each entry
    point's name and arguments (host pointer arrays read out as lists) and
    launches nothing."""

    def __init__(self) -> None:
        self.calls: list[tuple[str, list]] = []

    def __getattr__(self, name: str):
        if not name.startswith('pccf_'):
            raise AttributeError(name)

        def record(*args):
            self.calls.append((name, [list(a) if isinstance(a, ctypes.Array) else a for a in args]))
            return 0

        return record


@pytest.fixture()
def recording(monkeypatch):
    """The stand-in library for one test; the launch counts its calls add
    are put back afterwards (it launched nothing), so a later test in the
    process that checks the counts starts from what it would have found."""
    lib = RecordingLib()
    monkeypatch.setattr(_build, 'lib', lambda: lib)
    monkeypatch.setattr(_build, 'stream', lambda: 0)
    counts = api.launch_counts()
    yield lib
    for name, fn in api.KERNELS.items():
        fn.launches = counts[name]


def drive_stack(pack, decoder, b=2, t=128, t_mem=64, n_heads=2):
    """One stack over zeros through :class:`wformer.Stacks` on the CPU, as the
    CUDA wrappers drive it; returns the residual and memory buffers."""
    d = pack[0]['wo'].shape[0]
    res, memory = torch.zeros(b * t, d), torch.zeros(b * t_mem, d)
    stacks = wformer.Stacks(b, t, d, torch.device('cpu'))
    if decoder:
        stacks.decoder(res, memory, pack, n_heads)
    else:
        stacks.encoder(res, pack, n_heads)
    return res, memory


@pytest.mark.parametrize('decoder', [False, True])
def test_launch_work_sums_to_the_stack(recording, decoder):
    """gemm_work over every pccf_gemm launch and attention_work over every
    pccf_attention launch of a stack add up to its stack count, operation for
    operation (mixed FF widths, a memory shorter than the tokens)."""
    b, t, t_mem, d = 2, 128, 64, 64
    pack = _pack(d, (128, 64), decoder)
    drive_stack(pack, decoder, b, t, t_mem)
    ops = 0.0
    for name, args in recording.calls:
        if name == 'pccf_gemm':
            _, groups, operands, res, m, n, k, res_rows, _, _ = args
            biases = operands[2 * groups: 3 * groups]
            ops += roofline.gemm_work(m, n, k, groups, all(biases), res_rows if res else 0).ops
        elif name == 'pccf_attention':
            batch, t_q, t_k, n_heads, head_dim = args[7:12]
            ops += roofline.attention_work(batch, t_q, t_k, n_heads, head_dim).ops
    x, memory = torch.empty(b, t, d), torch.empty(b, t_mem, d)
    work = roofline.decoder_stack_work(x, memory, pack) if decoder else roofline.encoder_stack_work(x, pack)
    assert ops == work.ops


def test_launch_work_at_the_headline_shapes():
    """pccf_gemm at (8192, 512, 512) with a bias moves 34.6 MB for 4.3 GFLOP
    and is bound by bytes, its q/k/v launch by operations; pccf_attention at
    (32, 256, 256, 8 x 64) moves 67 MB for 4.3 GFLOP, bound by bytes."""
    gemm = roofline.gemm_work(8192, 512, 512)
    assert gemm.ops == 2 * 8192 * 512 * 512 and gemm.bytes == 4 * (2 * 8192 * 512 + 512 * 512 + 512)
    grouped = roofline.gemm_work(8192, 512, 512, groups=3)
    assert grouped.ops == 3 * gemm.ops and grouped.bytes == 4 * (4 * 8192 * 512 + 3 * (512 * 512 + 512))
    attn = roofline.attention_work(32, 256, 256, 8, 64)
    assert attn.ops == 4 * 32 * 256 * 256 * 512 and attn.bytes == 4 * 4 * 32 * 256 * 512
    for work, by in ((gemm, 'bytes'), (grouped, 'operations'), (attn, 'bytes')):
        want = work.bytes / 3.35e12 * 1e3 if by == 'bytes' else work.ops / 495e12 * 1e3
        assert roofline.bound_ms(work) == (pytest.approx(want), by)


def test_split_work_is_bound_by_bytes():
    """pccf_tf32_split over a W-encoder's matrices reads and writes each
    element once (8 bytes) for 4 operations: 16.8 MB a layer of width 512
    and FF 1024, bound by bytes."""
    pack = _pack(512, (1024, 1024), False, 'meta')
    work = roofline.split_work(wformer.stack_weights(pack))
    n = 2 * (4 * 512 * 512 + 2 * 512 * 1024)
    assert (work.ops, work.bytes) == (4 * n, 8 * n)
    assert roofline.bound_ms(work) == (pytest.approx(8 * n / 3.35e12 * 1e3), 'bytes')


def test_flagship_stacks_are_bound_by_operations():
    x = torch.empty(32, 256, 512, device='meta')
    enc = roofline.encoder_stack_work(x, _pack(512, (1024, 1024), False, 'meta'))
    dec = roofline.decoder_stack_work(x, x, _pack(512, (1024, 1024, 1024, 512), True, 'meta'))
    assert enc.ops / 1e9 == pytest.approx(77.31, abs=0.01)
    assert dec.ops / 1e9 == pytest.approx(231.9, abs=0.1)
    # inputs and outputs of 16.8 MB each, 8.4 MB of fp32 weights per encoder layer
    assert enc.bytes / 1e6 == pytest.approx(2 * 16.78 + 2 * 8.4, abs=0.1)
    (enc_ms, enc_by), (dec_ms, dec_by) = roofline.bound_ms(enc), roofline.bound_ms(dec)
    assert (enc_by, dec_by) == ('operations', 'operations')
    assert enc_ms == pytest.approx(enc.ops / 495e12 * 1e3) and dec_ms == pytest.approx(0.4685, abs=1e-3)


def test_gather_kernels_are_bound_by_bytes():
    x = torch.empty(8, 2048, 512, device='meta')
    idx = torch.empty(8, 2048, 25, dtype=torch.int32, device='meta')
    ms, by = roofline.bound_ms(roofline.pool_work(x, idx))
    assert by == 'bytes' and ms == pytest.approx((2 * x.numel() * 4 + idx.numel() * 4) / 3.35e12 * 1e3)
    ms, by = roofline.bound_ms(roofline.knn_work(torch.empty(16, 2048, 128, device='meta'), 25))
    assert by == 'operations' and ms == pytest.approx(2 * 16 * 2048**2 * 128 / 495e12 * 1e3)


def test_loss_kernels_are_bound_by_operations():
    """The nearest-neighbour and Sinkhorn kernels at the flagship (8, 2048,
    3)^2: operations per pair by the counts in roofline.py, fp32 peak."""
    x = torch.empty(8, 2048, 3, device='meta')
    pairs = 8 * 2048 * 2048
    nn = roofline.nn_distance_work(x, x)
    assert nn.ops == 11 * pairs and nn.bytes == 2 * x.numel() * 4 + 2 * 8 * 2048 * 8
    sink = roofline.sinkhorn_work(x, x)
    assert roofline.SINKHORN_OPS_PER_PAIR == 75
    assert sink.ops == 75 * pairs and sink.bytes == 4 * x.numel() * 4 + 8 * 4 + 2 * 8 * 2048 * 8
    for work in (nn, sink):
        ms, by = roofline.bound_ms(work)
        assert by == 'operations' and ms == pytest.approx(work.ops / 67e12 * 1e3)


@pytest.mark.parametrize('c,peak', [(3, 67e12), (16, 67e12), (64, 495e12), (128, 495e12)])
def test_knn_work_takes_the_class_its_path_issues(c, peak):
    """fp32 FMA up to 16 channels, 3xTF32 on the tensor cores above (the
    product counted once, as gemm_work counts the stacks' 3xTF32 GEMM); the
    headline (16, 2048, 128) k=25 is bound by operations at 0.0347 ms."""
    x = torch.empty(16, 2048, c, device='meta')
    work = roofline.knn_work(x, 25)
    assert work.peak == peak and work.ops == 2 * 16 * 2048**2 * c
    assert work.bytes == x.numel() * 4 + 16 * 2048 * 25 * 4
    if c == 128:
        assert roofline.bound_ms(work) == (pytest.approx(0.0347, abs=1e-4), 'operations')


@pytest.mark.parametrize('b', [1, 8, 16])
def test_filter_work_counts_the_search_and_the_bytes(b):
    """Graph filtering's fused pass: the forward's k = 4 search counted as
    knn_work counts it (3 multiply-adds a pair, fp32), x read once, the
    output, the (B, N, 4) indices and the (B,) mean written once, bound by
    operations (0.0060 ms at serving's batch 16); the backward's operations
    a point, x, the indices, the mean and g read, dx written, bound by
    bytes."""
    x = torch.empty(b, 2048, 3, device='meta')
    fwd, bwd = roofline.filter_work(x), roofline.filter_work(x, backward=True)
    assert fwd.ops == roofline.knn_work(x, 4).ops == 2 * b * 2048**2 * 3 and fwd.peak == roofline.FP32
    assert fwd.bytes == b * 2048 * (12 + 12 + 16) + 4 * b
    assert bwd.ops == roofline.FILTER_BACKWARD_OPS_PER_POINT * b * 2048
    assert bwd.bytes == b * 2048 * (3 * 12 + 16) + 4 * b
    assert roofline.bound_ms(fwd)[1] == 'operations' and roofline.bound_ms(bwd)[1] == 'bytes'
    if b == 16:
        assert roofline.bound_ms(fwd)[0] == pytest.approx(0.0060, abs=1e-4)


def test_pcgen_work_is_bound_by_half_precision_operations():
    """The fused PCGen's products run as fp16 wgmma, at the H100's dense
    bf16 and fp16 peak, 989 TFLOP/s: the flagship batch of 16 clouds (0.69
    TFLOP) is bound by operations at ~0.70 ms."""
    from pccf_torch.kernels import pcgen

    assert roofline.BF16 == roofline.FP16 == 989e12
    g, dims, dm = 8, (1024, 1024, 256, 16), 64

    def e(*shape):
        return torch.empty(shape, device='meta')

    pack = pcgen.PCGenPack(map_w=e(dims[0], dm), map_b=e(dims[0]),
                           layer_ws=tuple(e(g, dims[i + 1], dims[i]) for i in range(3)),
                           layer_bs=tuple(e(g, dims[i + 1]) for i in range(3)),
                           head_w=e(g, 3, 16), head_b=e(g, 3), att_w=e(g, g * 16), att_b=e(g))
    m, w = e(16, 2048, dm), e(16, dims[0])
    work = roofline.pcgen_work(m, w, pack)
    assert work.peak == roofline.FP16
    assert work.ops / 1e12 == pytest.approx(0.6937, abs=1e-3)
    assert roofline.bound_ms(work) == (pytest.approx(0.7014, abs=1e-3), 'operations')


def test_pcgen_general_work_is_bound_by_tf32_operations():
    """The general PCGen kernel multiplies TF32 operands: the tuning corner
    1024-500-300-77 with a map of 200 and 8 components at batch 16 (0.37
    TFLOP, the plain version's operations) is bound by operations at ~0.75
    ms, and its fp32 weights move twice the fp16 kernel's bytes."""
    from pccf_torch.kernels import pcgen

    g, dims, dm = 8, (1024, 500, 300, 77), 200

    def e(*shape):
        return torch.empty(shape, device='meta')

    pack = pcgen.PCGenPack(map_w=e(dims[0], dm), map_b=e(dims[0]),
                           layer_ws=tuple(e(g, dims[i + 1], dims[i]) for i in range(3)),
                           layer_bs=tuple(e(g, dims[i + 1]) for i in range(3)),
                           head_w=e(g, 3, 77), head_b=e(g, 3), att_w=e(g, g * 77), att_b=e(g))
    m, w = e(16, 2048, dm), e(16, dims[0])
    work, half = roofline.pcgen_general_work(m, w, pack), roofline.pcgen_work(m, w, pack)
    assert work.peak == roofline.TF32 and work.ops == half.ops
    assert work.bytes - half.bytes == 2 * sum(lw.numel() for lw in pack.layer_ws)
    assert work.ops / 1e12 == pytest.approx(0.3730, abs=1e-3)
    assert roofline.bound_ms(work) == (pytest.approx(0.7536, abs=1e-3), 'operations')
