"""Plot the decoder tuning study (``plot_optimization_decoder.py``).

Composes the stage-1 tuning tree (``configs/tuning/autoencoder``) with
``tune=decoder`` and the command line's overrides, opens the study the
tuning entry point wrote (its name from the version, the fixed overrides
and the tuning scheme) and draws it with
:func:`pccf_torch.tuning.visualize_study` into ``<db_location>/<study
name>``; where matplotlib does not import it logs one line and draws
nothing.  Nothing runs on the card.

    python -m pccf_torch.plot_optimization_decoder 'overrides=["data/dataset=synthetic"]'
"""

from __future__ import annotations

import pathlib
import sys

from pccf_torch import tuning
from pccf_torch.compose import compose
from pccf_torch.config import VERSION

TUNING_DIR = pathlib.Path(__file__).resolve().parents[1] / 'configs' / 'tuning' / 'autoencoder'


def plot_study(tuning_dir: pathlib.Path, study_group: str, argv: list[str]) -> list[pathlib.Path]:
    """The plots of the study ``tune=<study_group>`` of ``tuning_dir``'s tree
    under the overrides ``argv`` (``plot_optimization_decoder.py:15-23``),
    their paths printed."""
    tune_cfg = compose(tuning_dir, 'defaults', overrides=[f'tune={study_group}'] + list(argv))
    study_name = tuning.get_study_name(f'v{VERSION}', 'main', tune_cfg['tune']['study_name'],
                                       tune_cfg.get('overrides', []))
    study = tuning.create_study(study_name=study_name, storage=tune_cfg['storage'])
    out = tuning.visualize_study(study, pathlib.Path(tune_cfg['db_location']) / study_name)
    print('\n'.join(str(p) for p in out) or 'no completed trials to plot')
    return out


def main(argv: list[str] | None = None, study_group: str = 'decoder') -> list[pathlib.Path]:
    return plot_study(TUNING_DIR, study_group, sys.argv[1:] if argv is None else argv)


if __name__ == '__main__':
    main()
