"""The port's model downloader (caliscope_tpu_torch/pose/model_download.py)
on the cases of tests/test_overlay_and_download.py:100-170, driven with
file:// URLs only: checksum, extraction and error handling run without a
network. Its sha256 is the JAX package's, and for the same card both
packages leave the same bytes at the model path."""

from __future__ import annotations

import zipfile
from pathlib import Path

import pytest

from caliscope_tpu.pose import model_download as JMD
from caliscope_tpu.pose.model_card import ModelCard as JaxCard

from caliscope_tpu_torch.estimators import vertical as TV
from caliscope_tpu_torch.exceptions import CalibrationError
from caliscope_tpu_torch.pose.model_card import ModelCard
from caliscope_tpu_torch.pose.model_download import download_model, ensure_model, sha256_of


def _fields(tmp_path: Path, **kw) -> dict:
    fields = dict(
        name="toy",
        model_path=tmp_path / "models" / "toy.onnx",
        format="simcc",
        input_width=192,
        input_height=256,
        confidence_threshold=0.3,
        point_name_to_id={"nose": 0},
        wireframe=None,
    )
    fields.update(kw)
    return fields


def _card(tmp_path: Path, **kw) -> ModelCard:
    return ModelCard(**_fields(tmp_path, **kw))


def test_existing_model_short_circuits(tmp_path):
    card = _card(tmp_path)
    card.model_path.parent.mkdir(parents=True)
    card.model_path.write_bytes(b"weights")
    assert ensure_model(card) == card.model_path


def test_missing_without_url_raises_with_remedy(tmp_path):
    card = _card(tmp_path, source_url=None)
    with pytest.raises(CalibrationError, match="manually"):
        ensure_model(card)


def test_direct_download_from_file_url(tmp_path):
    src = tmp_path / "payload.onnx"
    src.write_bytes(b"onnx-bytes" * 100)
    assert sha256_of(src) == JMD.sha256_of(src)
    card = _card(tmp_path, source_url=src.as_uri(), sha256=sha256_of(src))
    got = ensure_model(card)
    assert got == card.model_path
    assert card.model_path.read_bytes() == src.read_bytes()


def test_checksum_mismatch_raises_and_cleans_up(tmp_path):
    src = tmp_path / "payload.onnx"
    src.write_bytes(b"corrupted")
    card = _card(tmp_path, source_url=src.as_uri(), sha256="0" * 64)
    with pytest.raises(CalibrationError, match="[Cc]hecksum"):
        download_model(card)
    assert not card.model_path.exists()
    assert list(card.model_path.parent.glob("*.download")) == []  # no stray temp files


def _bundle(path: Path, members: dict[str, str]) -> Path:
    with zipfile.ZipFile(path, "w") as z:
        for name, text in members.items():
            z.writestr(name, text)
    return path


@pytest.mark.parametrize(
    "members, want",
    [
        ({"other/readme.txt": "hi", "other/model.onnx": "decoy", "deploy/end2end.onnx": "the-real-model"}, "the-real-model"),
        ({"model.onnx": "only-model"}, "only-model"),
    ],
    ids=["prefers_end2end", "falls_back_to_any_onnx"],
)
def test_zip_extraction_as_the_jax_package(tmp_path, members, want):
    archive = _bundle(tmp_path / "bundle.zip", members)
    kw = dict(source_url=archive.as_uri(), sha256=sha256_of(archive), extraction="zip_end2end")
    assert download_model(_card(tmp_path / "port", **kw)).read_text() == want
    jax_card = JaxCard(**_fields(tmp_path / "jax", **kw))
    assert JMD.download_model(jax_card).read_bytes() == (tmp_path / "port" / "models" / "toy.onnx").read_bytes()


def test_zip_without_onnx_raises(tmp_path):
    archive = _bundle(tmp_path / "bundle.zip", {"readme.txt": "nothing here"})
    card = _card(tmp_path, source_url=archive.as_uri(), extraction="zip_end2end")
    with pytest.raises(CalibrationError, match="onnx"):
        download_model(card)


def test_unreachable_url_raises_with_manual_remedy(tmp_path):
    card = _card(tmp_path, source_url=(tmp_path / "absent.onnx").as_uri())
    with pytest.raises(CalibrationError, match="manually"):
        download_model(card)


def test_progress_callback_reports_completion(tmp_path):
    src = tmp_path / "payload.onnx"
    src.write_bytes(b"x" * (1 << 12))
    card = _card(tmp_path, source_url=src.as_uri())
    seen: list[int] = []
    download_model(card, progress=lambda pct, msg: seen.append(pct))
    assert seen and seen[-1] == 100  # file:// responses state their length


def test_vertical_ensure_model_uses_an_existing_file(tmp_path):
    """The vertical estimator's model is found where the downloader would
    put it, without a download."""
    path = tmp_path / TV.GEOCALIB_FILENAME
    path.write_bytes(b"model")
    assert TV.ensure_model(tmp_path) == path
