"""The paper's running example (Listings 1–5 and the Appendix-A node) on
the port, against ``repro``.

``build_pipeline(with_friend=True)`` runs after ``seed_lake`` through the
port's ``Client.run`` on ``TorchAutoBackend(device="cpu")``, and through
``repro``'s ``Client.run`` on its default backend. Every published table
has the same fingerprint (values, validity, dtypes, row and column
order), and the port's run asserts what ``repro``'s
``tests/test_pipeline_e2e.py::test_paper_pipeline_config_module``
asserts.
"""
import pytest

pytest.importorskip("jax")

from repro.configs import paper_pipeline as jpaper  # noqa: E402
from repro.core.planner import plan as jplan  # noqa: E402
from repro.core.runner import Client as JClient  # noqa: E402

from repro_torch.configs.paper_pipeline import (build_pipeline,  # noqa: E402
                                                seed_lake)
from repro_torch.core.planner import plan  # noqa: E402
from repro_torch.core.runner import Client  # noqa: E402
from repro_torch.exec import torch_auto, use_backend  # noqa: E402
from repro_torch.exec.torch_auto import TorchAutoBackend  # noqa: E402
from repro_torch.exec.torch_backend import TorchBackend  # noqa: E402

STEPS = ["parent_table", "child_table", "grand_child", "family_friend"]


def run_repro(rows: int) -> dict:
    c = JClient()
    jpaper.seed_lake(c, rows=rows)
    res = c.run(jplan(jpaper.build_pipeline(with_friend=True)), "main")
    assert res.state.status == "committed"
    return {t: c.read_table("main", t).fingerprint() for t in res.tables}


def run_port(rows: int) -> tuple[Client, object, list]:
    c = Client()
    seed_lake(c, rows=rows)
    pl = plan(build_pipeline(with_friend=True))
    with use_backend(TorchAutoBackend(device="cpu")):
        res = c.run(pl, "main")
    return c, res, [s.node.name for s in pl.steps]


# 5 rows is seed_lake's default (the paper's Listing 1); 64 and 65 sit on
# torch_auto's tiny-table edge; the rest take the host rows
@pytest.mark.parametrize("rows", [5, 64, 65, 1000, 20_000])
def test_paper_pipeline_matches_repro(rows):
    c, res, names = run_port(rows)
    assert names[:3] == STEPS[:3] and "family_friend" in names
    assert res.state.status == "committed"
    ff = c.read_table("main", "family_friend")
    assert not ff.has_nulls("col5")        # [NotNull] enforced physically
    got = {t: c.read_table("main", t).fingerprint() for t in res.tables}
    assert sorted(got) == sorted(STEPS)
    assert got == run_repro(rows)


@pytest.mark.parametrize("rows", [1000, 20_000])
def test_paper_pipeline_on_the_card_rows(monkeypatch, rows):
    """With torch_auto's device threshold lowered, the parent's
    GROUP BY takes the segment-kernel row (their plain versions here)
    and publishes the same fingerprints."""
    monkeypatch.setattr(torch_auto, "DEVICE_ROWS", 100)
    calls = []
    real = TorchBackend._aggregate

    def spy(self, *a):
        calls.append(self.name)
        return real(self, *a)

    monkeypatch.setattr(TorchBackend, "_aggregate", spy)
    c, res, _ = run_port(rows)
    assert res.state.status == "committed"
    assert calls == ["torch"]
    got = {t: c.read_table("main", t).fingerprint() for t in res.tables}
    assert got == run_repro(rows)
