"""Model download with sha256 verification and zip extraction.

Host-only copy of caliscope_tpu/pose/model_download.py: `ensure_model`
returns a card's model path, downloading it first when the file is absent;
`download_model` fetches the card's source URL (urllib), checks the sha256
the card pins, and either moves the file into place or extracts the
archive's `.onnx` member, preferring one named `end2end.onnx`. A failed
download raises CalibrationError with the manual-download remedy.
"""

from __future__ import annotations

import hashlib
import logging
import shutil
import tempfile
import zipfile
from pathlib import Path

from caliscope_tpu_torch.exceptions import CalibrationError
from caliscope_tpu_torch.pose.model_card import ModelCard

logger = logging.getLogger(__name__)


def sha256_of(path: Path, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def ensure_model(card: ModelCard, progress=None) -> Path:
    """Return the model path, downloading and verifying it if absent."""
    if card.onnx_exists:
        return card.model_path
    if not card.has_source_url:
        raise CalibrationError(
            f"Model {card.name} is missing at {card.model_path} and the card has no "
            f"source URL; place the .onnx file there manually."
        )
    return download_model(card, progress=progress)


def download_model(card: ModelCard, progress=None) -> Path:
    """Fetch the card's source URL into its model path. `progress`, if given,
    is called as progress(percent, message) while the body arrives (when the
    response states its length)."""
    import urllib.error
    import urllib.request

    card.model_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkstemp(suffix=".download", dir=card.model_path.parent)[1])
    try:
        logger.info(f"Downloading {card.name} from {card.source_url}")
        try:
            with urllib.request.urlopen(card.source_url, timeout=60) as resp, open(tmp, "wb") as out:
                total = int(resp.headers.get("Content-Length") or 0)
                done = 0
                while True:
                    chunk = resp.read(1 << 20)
                    if not chunk:
                        break
                    out.write(chunk)
                    done += len(chunk)
                    if progress is not None and total:
                        progress(int(100 * done / total), f"downloading {card.name}")
        except (urllib.error.URLError, OSError) as e:
            raise CalibrationError(
                f"Could not download {card.name} ({e}). Download it manually from "
                f"{card.source_url} and place the .onnx at {card.model_path}."
            ) from e

        if card.sha256 is not None:
            actual = sha256_of(tmp)
            if actual != card.sha256:
                raise CalibrationError(
                    f"Checksum mismatch for {card.name}: expected {card.sha256}, got {actual}. "
                    f"The download may be corrupt or the source changed."
                )

        if card.extraction == "zip_end2end":
            with zipfile.ZipFile(tmp) as z:
                onnx_members = [m for m in z.namelist() if m.endswith("end2end.onnx")]
                if not onnx_members:
                    onnx_members = [m for m in z.namelist() if m.endswith(".onnx")]
                if not onnx_members:
                    raise CalibrationError(f"No .onnx file inside the downloaded archive for {card.name}.")
                with z.open(onnx_members[0]) as src, open(card.model_path, "wb") as dst:
                    shutil.copyfileobj(src, dst)
        else:
            shutil.move(str(tmp), card.model_path)
        logger.info(f"Model ready: {card.model_path}")
        return card.model_path
    finally:
        tmp.unlink(missing_ok=True)
