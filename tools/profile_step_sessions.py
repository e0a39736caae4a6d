"""Does ``torch.profiler`` see every device launch of a stage-1 training step?

Builds the flagship VQ-VAE (random weights from a seed) and its ChamferEMD
trainer on one batch of 8 synthetic 2048-point clouds, as ``chip_smoke.py``
does, takes 3 untraced steps, then traces N steps, one profiler session each
(CPU and CUDA activities, ``TEARDOWN_CUPTI=0``, as ``chip_smoke.py`` traces
its steps), and prints one JSON line: the device activities of each session,
the most any session saw and how many saw fewer.  Run it from the root of
each checkout to compare them:

    python3 tools/profile_step_sessions.py 40 tree
"""

import json
import os
import sys
from pathlib import Path

os.environ['TEARDOWN_CUPTI'] = '0'
sys.path.insert(0, str(Path.cwd()))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from pccf_torch.config import SliceConfig  # noqa: E402
from pccf_torch.data import synthetic  # noqa: E402
from pccf_torch.data.structures import Inputs, Targets  # noqa: E402
from pccf_torch.models import build_vqvae  # noqa: E402
from pccf_torch.nn.layers import init_from_seed  # noqa: E402
from pccf_torch.train import Trainer, get_autoencoder_loss  # noqa: E402


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__.split('\n\n')[-1], file=sys.stderr)
        return 2
    n_sessions, label = int(sys.argv[1]), sys.argv[2]
    if not torch.cuda.is_available():
        print('no CUDA card', file=sys.stderr)
        return 1
    dev = torch.device('cuda')
    cfg = SliceConfig()
    model = build_vqvae(cfg)
    init_from_seed(model, 2)
    trainer = Trainer(model.to(dev), get_autoencoder_loss(cfg), cfg.autoencoder.train, 100, seed=0)
    batch = torch.from_numpy(synthetic.batch(3, 8, 2048)).to(dev)
    inputs, targets = Inputs(batch), Targets(batch)
    for _ in range(3):
        trainer.run_step(inputs, targets)
    torch.cuda.synchronize()
    counts = []
    for _ in range(n_sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trainer.run_step(inputs, targets)
            torch.cuda.synchronize()
        counts.append(sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA))
        prof.key_averages()  # as chip_smoke.py reads its table after each session
    full = max(counts)
    print(label, json.dumps({'sessions': n_sessions, 'max': full, 'short': sum(c < full for c in counts),
                             'counts': counts}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
