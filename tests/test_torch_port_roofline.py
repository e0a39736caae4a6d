"""The work model behind ``bound_ms`` in ``chip_smoke.py``
(``pccf_torch.kernels.roofline``), on the CPU.

The stacks' operation counts against ``torch.utils.flop_counter`` over the
plain versions (every matrix product counted as 2·M·N·K, exactly), and the
flagship stage-2 figures: 77.3 GFLOP for the W-encoder stack and 231.9 GFLOP
for the W-decoder stack at batch 32, both bound by operations.
"""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from pccf_torch.kernels import roofline, wformer

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
    assert by == 'operations' and ms == pytest.approx(2 * 16 * 2048**2 * 128 / 67e12 * 1e3)


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
