"""PyTorch port: ``signal/qc.py``, the port's own copy of the JAX
package's dataset QC, against it: the statistics and verdicts of a seeded
set of good and degenerate mels, and ``scan_and_move`` (the files moved and
the CSV rows written) and the CLI over the same tree."""

import csv
import os
from dataclasses import asdict

import numpy as np
import pytest

from mqgan_tpu.signal import qc as jax_qc
from mqgan_tpu_torch.signal import qc


def _cases():
    rng = np.random.default_rng(0)
    t, m = 200, 32
    good = rng.normal(-4.0, 2.0, (t, m)).astype(np.float32)
    good += np.sin(np.arange(t) / 7.0)[:, None].astype(np.float32)
    rank1 = (np.outer(np.linspace(0.5, 1.5, t), rng.normal(0, 1, m)) - 5).astype(np.float32)
    nan = good.copy()
    nan[3, 4] = np.nan
    inf = good.copy()
    inf[0, 0] = np.inf
    return {
        "good": good,
        "constant": np.full((t, m), -3.0, np.float32),
        "rank1": rank1,
        "static_columns": np.repeat(good[:1], t, axis=0),
        "nan": nan,
        "inf": inf,
        "too_loud": good + 100.0,
        "too_quiet": good - 100.0,
        "transposed": good.T.copy(),
        "one_d": np.zeros(10, np.float32),
        "three_d": np.zeros((2, 3, 4), np.float32),
        "one_frame": good[:1],
        "wrong_bins": rng.normal(-4.0, 2.0, (t, 40)).astype(np.float32),
    }


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_verdicts_match_jax(name):
    mel = CASES[name]
    kw = {"expect_bins": 32}
    got_bad, got = qc.mel_qc(mel, **kw)
    want_bad, want = jax_qc.mel_qc(mel, **kw)
    assert got_bad == want_bad
    assert got == want


def test_stats_match_jax_and_expected_verdicts():
    for name in ("good", "rank1", "static_columns", "one_frame"):
        got = qc.compute_stats(CASES[name].astype(np.float64))
        want = jax_qc.compute_stats(CASES[name].astype(np.float64))
        assert asdict(got) == asdict(want), name
    assert not qc.mel_qc(CASES["good"])[0]
    for name in ("constant", "nan", "too_loud", "one_d", "wrong_bins"):
        assert qc.mel_qc(CASES[name], expect_bins=32)[0], name
    assert qc.mel_qc(CASES["transposed"])[1]["transposed"]


def _tree(root):
    for i, (name, mel) in enumerate(sorted(CASES.items())):
        sub = os.path.join(root, f"part{i % 2}")
        os.makedirs(sub, exist_ok=True)
        np.save(os.path.join(sub, f"{name}.npy"), mel)
    with open(os.path.join(root, "part0", "broken.npy"), "wb") as f:
        f.write(b"not an npy file")


def _rows(path, root):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    for r in rows:  # the trees differ by their roots
        r["src"] = os.path.relpath(r["src"], root["src"])
        r["quarantined_to"] = os.path.relpath(r["quarantined_to"], root["dst"])
        if r["reasons"].startswith("load_error:"):
            r["reasons"] = "load_error"
    return rows


@pytest.mark.parametrize("mirror", [False, True])
def test_scan_and_move_matches_jax(tmp_path, mirror):
    dirs = {}
    for side, fn in (("port", qc.scan_and_move), ("jax", jax_qc.scan_and_move)):
        src, dst = str(tmp_path / side / "src"), str(tmp_path / side / "bad")
        _tree(src)
        counts = fn(src, dst, str(tmp_path / side / "bad.csv"), expect_bins=32,
                    mirror=mirror)
        dirs[side] = {"src": src, "dst": dst, "counts": counts,
                      "left": sorted(os.path.relpath(os.path.join(d, f), src)
                                     for d, _, fs in os.walk(src) for f in fs),
                      "moved": sorted(os.path.relpath(os.path.join(d, f), dst)
                                      for d, _, fs in os.walk(dst) for f in fs)}
    port, jax_side = dirs["port"], dirs["jax"]
    assert port["counts"] == jax_side["counts"] == {"total": len(CASES) + 1, "bad": 12}
    assert port["left"] == jax_side["left"]
    assert port["moved"] == jax_side["moved"]
    assert (_rows(str(tmp_path / "port" / "bad.csv"), port)
            == _rows(str(tmp_path / "jax" / "bad.csv"), jax_side))


def test_cli(tmp_path):
    src = str(tmp_path / "src")
    _tree(src)
    counts = qc.main([src, str(tmp_path / "bad"), "--csv", str(tmp_path / "r.csv"),
                      "--expect-bins", "32", "--val-min", "-30", "--val-max", "20",
                      "--mirror"])
    assert counts["total"] == len(CASES) + 1
    assert os.path.exists(tmp_path / "bad" / "part0" / "broken.npy")
    assert os.path.exists(tmp_path / "r.csv")
