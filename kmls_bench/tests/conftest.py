import json

import pytest


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def tiny(monkeypatch):
    """Cell specs cut to a size the CPU runs in seconds, with the server's
    admission control off (a CPU server sheds under the mixes' rates)."""
    import copy

    from kmls_bench import run

    monkeypatch.setenv("KMLS_SHED_QUEUE_BUDGET_MS", "0")
    monkeypatch.setenv("KMLS_NATIVE", "0")

    def spec(cell: str, traffic: str | None = None) -> dict:
        """The cell ``cell`` of BENCHMARK.json, or with ``traffic`` the
        serving configuration ``cell`` under that open mix."""
        if traffic is None:
            s = copy.deepcopy(run.load_cell(cell))
        else:
            s = {"cell": {"name": f"{cell}.{traffic}", "chips": 1},
                 "config": json.loads((run.HERE / "configs" / f"{cell}.json").read_text()),
                 "traffic": json.loads((run.HERE / "traffic" / f"{traffic}.json").read_text()),
                 "end_to_end": [{"name": n, "unit": u} for n, u in
                                (("serve_p50_ms", "ms"), ("serve_p95_ms", "ms"), ("setup_s", "s"))],
                 "per_layer": []}
        if s["config"]["driver"] == "mine":
            s["config"]["deployment"].update(playlists=2048, tracks=300, rows=30000, min_support=0.01)
        else:
            s["config"]["publication"].update(tracks=20000, playlists=100000, rows=2_000_000,
                                              min_support=0.005, rules=3000)
            s["traffic"].update(rate_per_s=30, pool_per_s=200, warm_requests=8, check_sample=100000,
                                trace_seconds=1.0, connections=4)
            if "clients" in s["traffic"]:
                s["traffic"]["clients"] = 4
        return s

    return spec
