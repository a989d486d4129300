"""The port's sync mapping (caliscope_tpu_torch/media/synchronized_timestamps.py)
held to the JAX package's: the same sync indices, frame for every camera at
every index, times and mean rate, on timestamp CSVs (offset starts, dropped
frames, unequal lengths, jitter, mixed rates, duplicates) read by each
package's own reader (the JAX package's through pandas), on the JAX suite's
cases built in memory, and on video metadata; the CSV the port writes is
the JAX package's byte for byte, and FrameTimestamps.from_csv agrees.
"""

from __future__ import annotations

from types import MappingProxyType

import numpy as np
import pytest

from caliscope_tpu.media import FrameTimestamps as JaxFrameTimestamps
from caliscope_tpu.media import SynchronizedTimestamps as JaxSync

from caliscope_tpu_torch.media import FrameTimestamps, SynchronizedTimestamps
from caliscope_tpu_torch.media.video import write_gray_video


def _cases():
    rng = np.random.default_rng(4)
    base = [i / 30 for i in range(40)]
    return {
        "aligned": {0: base, 1: base, 2: base},
        "offset": {0: base, 1: [t + 0.07 for t in base[:31]], 2: [t + 0.21 for t in base[5:]]},
        "dropped": {0: base, 1: [t for i, t in enumerate(base) if i % 7 != 3], 2: [t for i, t in enumerate(base) if i % 5 != 1]},
        "unequal": {0: base, 1: base[:12], 2: [t + 0.5 for t in base[:25]]},
        "jitter": {c: sorted(t + rng.normal(scale=0.004) for t in base) for c in range(4)},
        "mixed_rates": {0: [i / 30 for i in range(30)], 1: [i / 60 for i in range(60)], 2: [i / 25 + 0.013 for i in range(25)]},
        "duplicates": {0: [0.0, 0.0, 0.1, 0.2, 0.2], 1: [0.0, 0.1, 0.1, 0.2]},
        "disjoint": {0: [0.0, 0.1, 0.2], 1: [100.0, 100.1, 100.2]},
        "single": {3: base[:9]},
    }


CASES = _cases()


def _write_csv(path, cams):
    rows = [(cid, t) for cid in sorted(cams) for t in cams[cid]]
    order = np.random.default_rng(0).permutation(len(rows))  # rows need not be sorted
    lines = ["sync_index,cam_id,frame_time"] + [f"{i},{rows[k][0]},{rows[k][1]!r}" for i, k in enumerate(order)]
    path.write_text("\n".join(lines) + "\n")


def _assert_same(got, want, exact=True):
    """The same mapping, frame for frame. Times read from a CSV may part in
    the last digits (seen 6.6e-17): pandas' float parser, which the JAX
    package reads through, is not correctly rounded (ROADMAP.md section 3);
    exact=False allows 2e-15 relative plus 1e-16, and only in the times and
    the mean rate."""
    assert got.sync_indices == want.sync_indices
    assert got.cam_ids == want.cam_ids
    for si in want.sync_indices:
        for cid in want.cam_ids:
            assert got.frame_for(si, cid) == want.frame_for(si, cid), (si, cid)
    for cid in want.cam_ids:
        g, w = dict(got.for_camera(cid).frame_times), dict(want.for_camera(cid).frame_times)
        assert sorted(g) == sorted(w)
        if exact:
            assert g == w
        elif g:
            np.testing.assert_allclose([g[k] for k in sorted(g)], [w[k] for k in sorted(w)], rtol=2e-15, atol=1e-16)
    if exact:
        assert got.mean_fps == want.mean_fps
    else:
        assert got.mean_fps == pytest.approx(want.mean_fps, rel=1e-12, abs=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_mapping_from_csv_matches_jax(tmp_path, case):
    _write_csv(tmp_path / "timestamps.csv", CASES[case])
    _assert_same(SynchronizedTimestamps.from_csv(tmp_path), JaxSync.from_csv(tmp_path), exact=False)


@pytest.mark.parametrize("case", sorted(CASES))
def test_mapping_from_timestamps_matches_jax(case):
    cams = CASES[case]
    got = SynchronizedTimestamps.from_timestamps(
        {c: FrameTimestamps(MappingProxyType(dict(enumerate(ts)))) for c, ts in cams.items()}
    )
    want = JaxSync.from_timestamps({c: JaxFrameTimestamps(MappingProxyType(dict(enumerate(ts)))) for c, ts in cams.items()})
    _assert_same(got, want)


def test_empty_camera_stream_matches_jax():
    cams = {0: [0.0, 0.1, 0.2], 1: []}
    got = SynchronizedTimestamps.from_timestamps({c: FrameTimestamps(MappingProxyType(dict(enumerate(t)))) for c, t in cams.items()})
    want = JaxSync.from_timestamps({c: JaxFrameTimestamps(MappingProxyType(dict(enumerate(t)))) for c, t in cams.items()})
    _assert_same(got, want)


@pytest.mark.parametrize("case", ["offset", "jitter", "mixed_rates"])
def test_to_csv_is_the_jax_bytes(tmp_path, case):
    cams = CASES[case]
    stamps = {c: dict(enumerate(ts)) for c, ts in cams.items()}
    SynchronizedTimestamps.from_timestamps(
        {c: FrameTimestamps(MappingProxyType(s)) for c, s in stamps.items()}
    ).to_csv(tmp_path / "port.csv")
    JaxSync.from_timestamps({c: JaxFrameTimestamps(MappingProxyType(s)) for c, s in stamps.items()}).to_csv(tmp_path / "jax.csv")
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    _assert_same(SynchronizedTimestamps.from_csv_path(tmp_path / "jax.csv"), JaxSync.from_csv_path(tmp_path / "port.csv"), exact=False)


def test_frame_timestamps_from_csv_and_inferred(tmp_path):
    _write_csv(tmp_path / "timestamps.csv", CASES["offset"])
    for cid in (0, 1, 2):
        got = FrameTimestamps.from_csv(tmp_path / "timestamps.csv", cid)
        want = JaxFrameTimestamps.from_csv(tmp_path / "timestamps.csv", cid)
        np.testing.assert_allclose(list(got.frame_times.values()), list(want.frame_times.values()), rtol=2e-15, atol=1e-16)
        assert (got.start_frame_index, got.last_frame_index, len(got)) == (want.start_frame_index, want.last_frame_index, len(want))
    with pytest.raises(KeyError):
        FrameTimestamps.from_csv(tmp_path / "timestamps.csv", 9)
    assert dict(FrameTimestamps.inferred(30.0, 5).frame_times) == dict(JaxFrameTimestamps.inferred(30.0, 5).frame_times)


def test_mapping_from_video_metadata_matches_jax(tmp_path):
    frame = np.zeros((16, 16), np.uint8)
    videos = {}
    for cid, (n, fps) in enumerate([(9, 30.0), (7, 25.0), (12, 60.0)]):
        videos[cid] = tmp_path / f"cam_{cid}.mp4"
        write_gray_video(videos[cid], [frame] * n, fps=fps)
    _assert_same(SynchronizedTimestamps.from_video_paths(videos), JaxSync.from_video_paths(videos))
