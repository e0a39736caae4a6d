"""Export trained checkpoints as a self-contained serving artifact
(``export_artifact.py``).

Loads the classifier and the VQ-VAE of the current experiment's checkpoints
as :meth:`~pccf_torch.serve.CounterfactualServer.from_config` does, then
writes the ``torch.export`` programs and their manifest
(:mod:`pccf_torch.export`) to ``<version_dir>/artifacts/<name>/`` or to
``user.export.path``, for ``user.export.platforms`` (``[]``: the device the
entry point runs on, the card unless ``user.cpu``).

    python -m pccf_torch.export_artifact final=True 'user.export.platforms=[cuda,cpu]'
    python -m pccf_torch.export_artifact data/dataset=synthetic user.cpu=true
"""

from __future__ import annotations

from pathlib import Path

import torch

from pccf_torch import cli
from pccf_torch.config import SliceConfig, paths
from pccf_torch.export import export_server
from pccf_torch.serve import CounterfactualServer


def export_from_config(cfg: SliceConfig, device: torch.device) -> dict:
    """Export the experiment's server on ``device``; returns the manifest."""
    server = CounterfactualServer.from_config(cfg, device)
    export_cfg = cfg.user.export
    path = Path(export_cfg.path) if export_cfg.path else paths().version_dir / 'artifacts' / cfg.name
    manifest = export_server(server, path, n_points=cfg.data.n_input_points, n_classes=cfg.data.n_classes,
                             platforms=export_cfg.platforms or None, include_generate=export_cfg.include_generate)
    n_files = sum(len(e.get('buckets', {})) or 1 for ep in manifest['endpoints'].values() for e in ep.values())
    print(f'exported {n_files} modules for {manifest["platforms"]} -> {path}')
    return manifest


def main(argv: list[str] | None = None) -> dict:
    return cli.run(argv, export_from_config)


if __name__ == '__main__':
    main()
