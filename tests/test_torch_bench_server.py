"""python -m climsim_tpu_torch.bench_server end to end on the CPU, on
tiny networks (an MLP_v2rh of one hidden layer of 16, U-Nets of 8
channels): one JSON line a path, the program's call beside the direct
one, and the served legs' counts consistent with the requests sent."""

import json

from climsim_tpu_torch import bench_server as BS

TINY_UNET = ("model_kw.model_channels=8", "model_kw.channel_mult=[1]",
             "model_kw.num_blocks=1", "model_kw.attn_resolutions=[]")


def test_bench_server_end_to_end(capsys):
    argv = ["--device", "cpu", "--requests", "2", "--reps", "2",
            "--clients", "1,2", "--hidden", "16"]
    for o in TINY_UNET:
        argv += ["--set", o]
    lines = BS.main(argv)
    printed = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert printed == lines
    assert [d["path"] for d in lines] == list(BS.PATHS)
    for d in lines:
        assert d["device"] == "cpu" and d["batch"] == 384
        assert d["export_s"] > 0
        assert d["program_minus_live_p50_ms"] == \
            d["program_ms"]["p50"] - d["program_live_ms"]["p50"]
        if d["path"].startswith("unet") or d["path"].startswith("two"):
            assert d["program_live_ms"] == d["direct_ms"]
        for leg in ("direct_ms", "program_ms", "program_live_ms"):
            p = d[leg]
            assert p["n"] == 2 and 0 < p["p50"] <= p["p90"] <= p["p99"]
        assert set(d["served"]) == {"1", "2"}
        for c, s in d["served"].items():
            n = int(c) * 2
            assert s["requests"] == n
            assert s["round_trip_ms"]["n"] == n
            assert 1 <= s["device_calls"] <= n
            assert s["device_call_ms"]["n"] == s["device_calls"]
            assert s["rows_per_call"] * s["device_calls"] == 384 * n
            assert 0.0 <= s["pad_fraction"] < 1.0
            assert s["columns_per_s"] > 0
