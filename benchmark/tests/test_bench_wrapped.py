"""Every function the stage timers are swapped into exists in the program
under its name, and a traced run reaches each stage it should: a rename
in the program fails here, not silently in a chip run."""

from benchmark import clock, run, spec
from benchmark.tests.test_bench_faults import small


def test_wrapped_names_exist():
    from benchmark.loops import port

    p = port()
    import phfpfac_tpu_torch.ops.plan as plan_mod
    import phfpfac_tpu_torch.parallel.matcher as matcher_mod

    M, PSS = p.Matcher, plan_mod.PlanShardScanner
    for owner, name in [(M, "_dispatch"), (M, "_host_literal_one"),
                        (M, "_get_pallas_scanner"), (M, "match_chunked"),
                        (matcher_mod, "pad_input"),
                        (matcher_mod, "to_device_bytes"),
                        (matcher_mod, "fetch_hit_bits"),
                        (matcher_mod, "decode_hits"),
                        (matcher_mod, "merge_flat_matches"),
                        (PSS, "stage"), (PSS, "scan_async"),
                        (plan_mod, "plan_scan")]:
        assert callable(getattr(owner, name)), name


def test_traced_run_reaches_every_stage():
    """Every stage but the host tail, which only a pattern longer than
    32 B reaches (neither dictionary has one)."""
    for name in ("englishdic.text", "bigenglishdic.text"):
        r = run.Run(small(name), seed=3, seconds=0.3, trace=True,
                    device="cpu")
        out = r.go()
        s = r.loop.serial_stages
        for stage in clock.STAGES:
            if stage != "host_tail":
                assert s["calls"][stage] > 0, (name, stage)
        assert s["calls"]["k1"] == s["chunks"] * s["shards"]
        assert {"matcher.input_ms", "matcher.loop_ms",
                "result.fetch_decode_ms", "result.merge_ms"} <= set(
                    out["metrics"])
        # no device number from a CPU run
        assert "device.idle_pct.scan" not in out["metrics"]
        assert "kernel.scan_roofline_pct" not in out["metrics"]


def test_invoke_trace_reads_the_build():
    r = run.Run(small("englishdic.invoke"), seed=3, seconds=0.5,
                trace=True, device="cpu")
    out = r.go()
    assert {"compile.trie_s", "compile.tables_s"} == set(out["metrics"])
    assert all(i["tables_s"] > 0 for i in r.loop.invocations)
    assert spec.reports({"workloads": ["x"]}, "x")
