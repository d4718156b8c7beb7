"""The card soak (chip_fuzz.py) run on the CPU at tiny sizes: its arms
pass on the plain versions, a planted fault is reported with its route,
a seed draws the same geometry every time, and the class-dictionary
oracle it uses agrees with oracle/ac.py's brute-force one."""

import json

import numpy as np
import pytest

import chip_fuzz
from phfpfac_tpu_torch.oracle.ac import match_oracle_charset
from phfpfac_tpu_torch.parallel import matcher as tmatcher
from phfpfac_tpu_torch.parallel import mesh_pallas
from phfpfac_tpu_torch.parallel import stream as tstream
from phfpfac_tpu_torch.utils.config import PfacConfig

CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def tiny_corpora(monkeypatch):
    monkeypatch.setattr(chip_fuzz, "MAX_BYTES", 4096)


def _summary(capsys) -> dict:
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


@pytest.mark.parametrize("arm", [[], ["--segment"], ["--charset"]],
                         ids=["exact", "segment", "charset"])
def test_two_seeds_pass(arm, capsys):
    assert chip_fuzz.main([*CPU, "--seeds", "2", "--start", "0", *arm]) == 0
    s = _summary(capsys)
    assert s["ok"] and not s["failed_routes"] and not s["unreached_routes"]
    assert s["checks"]["match"] == s["checks"]["cli"] == 2
    assert s["checks"]["match_chunked"] == s["checks"]["device_data"] == 2
    assert s["total_checks"] >= 16


def test_dropped_stream_match_is_reported(monkeypatch, capsys):
    real = tstream.StreamMatcher.finish

    def finish(self):
        got = real(self)
        return got[1:]  # one match lost at the end of the stream

    monkeypatch.setattr(tstream.StreamMatcher, "finish", finish)
    assert chip_fuzz.main([*CPU, "--seeds", "1", "--start", "1",
                           "--segment"]) == 1
    s = _summary(capsys)
    assert s["failed_routes"] == ["stream"] and s["failed_checks"] == 1


def test_shifted_chunked_match_is_reported(monkeypatch, capsys):
    real = tmatcher.Matcher.match_chunked

    def match_chunked(self, *a, **kw):
        got = np.array(real(self, *a, **kw))
        got[len(got) // 2, 0] += 1  # one position off by one
        return got

    monkeypatch.setattr(tmatcher.Matcher, "match_chunked", match_chunked)
    assert chip_fuzz.main([*CPU, "--seeds", "1", "--start", "0"]) == 1
    s = _summary(capsys)
    assert {"match_chunked", "device_data"} <= set(s["failed_routes"])
    assert "match" not in s["failed_routes"]


def _off_by_one_count(real):
    def count_matches(self, *a, **kw):
        got = np.array(real(self, *a, **kw))
        got[len(got) // 2] += 1
        return got
    return count_matches


def _one_row_dropped(real):
    def match(self, *a, **kw):
        return np.array(real(self, *a, **kw))[1:]
    return match


@pytest.mark.parametrize("owner, name, fault, routes", [
    (tmatcher.Matcher, "count_matches", _off_by_one_count,
     ["count_matches"]),
    # MultiHostMatcher scans with the plan mesh
    (mesh_pallas.PlanMeshMatcher, "match", _one_row_dropped,
     ["multihost", "plan_mesh"]),
], ids=["count_matches", "plan_mesh"])
def test_planted_fault_names_its_route(owner, name, fault, routes,
                                       monkeypatch, capsys):
    monkeypatch.setattr(owner, name, fault(getattr(owner, name)))
    assert chip_fuzz.main([*CPU, "--seeds", "1", "--start", "0"]) == 1
    assert _summary(capsys)["failed_routes"] == routes


@pytest.mark.parametrize("arm", chip_fuzz.ARMS)
def test_geometry_is_the_seeds(arm):
    for seed in (0, 5, 123):
        assert chip_fuzz.draw_geometry(seed, arm) == \
            chip_fuzz.draw_geometry(seed, arm)
    assert chip_fuzz.draw_geometry(0, arm) != chip_fuzz.draw_geometry(1, arm)
    g = chip_fuzz.draw_geometry(7, arm)
    assert 1 <= g["num_shards"] <= 4 and g["width"] in (256, 512, 4096)
    assert 0 <= g["corpus_bytes"] - g["input_size"] <= 3
    assert sum(g["feeds"]) <= g["input_size"]


@pytest.mark.parametrize("seed", range(3))
def test_class_oracle_under_the_cut_is_the_brute_force_one(seed, tmp_path):
    for cfg in (PfacConfig(width=512, num_shards=2, truncation="none"),
                PfacConfig(width=512, num_shards=2, truncation="segment",
                           segment_bytes=256, halo_bytes=3 + seed)):
        case = chip_fuzz.make_case(chip_fuzz.CLASS_SOURCES[seed], seed, cfg,
                                   3000, str(tmp_path))
        want = match_oracle_charset(case.pats, case.data, cfg)
        assert chip_fuzz.oracle(case, case.data, cfg).tolist() == \
            [list(r) for r in want]
