"""Plot the W-decoder tuning study (``plot_optimization_w_decoder.py``):
:func:`pccf_torch.plot_optimization_decoder.plot_study` over the stage-2
tuning tree (``configs/tuning/w_autoencoder``) with ``tune=w_decoder``.

    python -m pccf_torch.plot_optimization_w_decoder 'overrides=["data/dataset=synthetic"]'
"""

from __future__ import annotations

import pathlib
import sys

from pccf_torch.plot_optimization_decoder import plot_study

TUNING_DIR = pathlib.Path(__file__).resolve().parents[1] / 'configs' / 'tuning' / 'w_autoencoder'


def main(argv: list[str] | None = None, study_group: str = 'w_decoder') -> list[pathlib.Path]:
    return plot_study(TUNING_DIR, study_group, sys.argv[1:] if argv is None else argv)


if __name__ == '__main__':
    main()
