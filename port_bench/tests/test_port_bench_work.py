"""The work counts behind the roofline shares, against the configurations'
defaults."""

import json

from port_bench import spec, work


def _config(name):
    here = spec.Pieces()
    return here.config(here.benchmark(), name)


def test_hbm_leg_reads_23040_sweeps_of_256_mib():
    hbm = _config("validator-1gpu")["hbm"]
    assert len(work.hbm_launches(hbm)) == 18
    assert sum(work.hbm_launches(hbm)) == 23_040
    assert work.hbm_array_bytes(hbm) == 256 * 2**20
    assert work.hbm_bytes(hbm) == 23_040 * 2**28 == 6_184_752_906_240


def test_matmul_leg_needs_1200_products_of_4096_cubed():
    mm = _config("validator-1gpu")["matmul"]
    assert len(work.matmul_chains(mm)) == 30
    assert sum(work.matmul_chains(mm)) == 1200
    assert work.matmul_flops(mm) == 1200 * 2 * 4096**3
    assert abs(work.matmul_flops(mm) - 1.649e14) < 0.001e14


def test_causal_attention_counts_2_d_t_t_plus_1():
    c = _config("attn-probe-16k")
    flops = work.attention_flops(c["t"], c["d"], c["causal"])
    assert flops == 2 * 128 * 16384 * 16385
    assert work.attention_flops(4, 2, False) == 4 * 2 * 16
    assert work.attention_flops(4, 2, True, heads=3) == 3 * 4 * 2 * 10


def test_benchmark_json_metrics_have_readers_and_cells():
    here = spec.Pieces()
    bench = here.benchmark()
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(here.module("metrics", m["name"]).read)
        assert set(m.get("workloads", cells)) <= cells
    for w in bench["workloads"]:
        config = here.config(bench, w["config"])
        assert config["chips"] == w["chips"]
        here.traffic(w["traffic"])
        here.module("entries", config["entry"])
        e2e = spec.metrics(bench, w["name"], trace=False)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert spec.metrics(bench, w["name"], trace=True)
    json.dumps(bench)
