"""Dataset download (``pccf/utils/download.py``, standard library only)."""

from __future__ import annotations

import logging
import pathlib
import urllib.request
import zipfile

logger = logging.getLogger('pccf_torch')


def download_extract_zip(target_folder: str | pathlib.Path, url: str) -> None:
    """Download and extract a zip archive unless the target already exists.

    Where the fetch fails (offline), this raises ``FileNotFoundError`` with
    the manual instructions instead.
    """
    target_folder = pathlib.Path(target_folder)
    if target_folder.exists():
        return
    target_folder.parent.mkdir(parents=True, exist_ok=True)
    zip_path = target_folder.with_suffix('.zip')
    logger.info('downloading %s', url)
    try:
        urllib.request.urlretrieve(url, zip_path)  # noqa: S310
    except Exception as e:
        raise FileNotFoundError(
            f'Could not download {url} ({e}). Download it manually and extract to {target_folder}.'
        ) from e
    with zipfile.ZipFile(zip_path) as zf:
        zf.extractall(target_folder.parent)
    zip_path.unlink(missing_ok=True)
