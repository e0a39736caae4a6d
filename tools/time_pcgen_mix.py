"""Time the fused PCGen kernel of the checkout the command runs in, at the
flagship widths (random decoder weights from seed 0), with that checkout's
``chip_smoke.time_ms``, and print ptxas's registers and spills of its kernels.

    cd <checkout> && python3 <path to>/tools/time_pcgen_mix.py

It calls only ``pcgen.pcgen_mix_cuda(m, w, pack, tau=, act_slope=)`` on the
decoder's ``pack()``, which every checkout since the kernel was ported
keeps, so running it from a parent's checkout and from a change's in one call
(parent, change, change, parent) compares the two kernels with nothing else
running before them.  The last line takes a latent 1e5 times larger, whose
activations pass fp16's range: whether the output stays finite.  Needs a CUDA
card.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

from chip_smoke import REPS, time_ms  # noqa: E402
from pccf_torch.config import SliceConfig  # noqa: E402
from pccf_torch.kernels import _build, pcgen  # noqa: E402
from pccf_torch.models import build_vqvae  # noqa: E402
from pccf_torch.nn.layers import init_from_seed  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print('no CUDA card', file=sys.stderr)
        return 1
    _build.build(verbose=True)
    for name, regs, stores, loads in _build.kernel_resources(_build.ptxas_logs.get('pcgen_mix.cu', '')):
        print(f'{name}: {regs} registers, spill stores / loads {stores} / {loads} bytes', flush=True)
    vqvae = build_vqvae(SliceConfig())
    init_from_seed(vqvae, 0)
    dec = vqvae.cuda().eval().decoder
    pack = dec.pack()
    rng = np.random.default_rng(0)
    for b, scale in ((1, 1.0), (16, 1.0), (64, 1.0), (16, 1e5)):
        m = torch.relu(torch.from_numpy(rng.standard_normal((b, 2048, 64)).astype(np.float32))).cuda()
        w = scale * torch.from_numpy(rng.standard_normal((b, 1024)).astype(np.float32)).cuda()

        def run(m=m, w=w):
            return pcgen.pcgen_mix_cuda(m, w, pack, tau=dec.tau, act_slope=0.0)

        finite = bool(torch.isfinite(run()).all())
        print(f'pcgen_mix ({b}, 2048, 64), latent x {scale:g}: {time_ms(run, REPS):.4f} ms, output finite {finite}',
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
