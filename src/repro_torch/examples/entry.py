"""What the port's copies of the paper's entry points share.

Each of ``quickstart``, ``agent_branch_workflow``, ``incremental_reruns``,
``optimized_pipeline``, ``sql_queries``, ``traced_run``,
``concurrent_writers``, ``agent_swarm`` and ``serve_pinned_commit``
(``python -m repro_torch.examples.<name> [--device cpu]``) is the root
``examples/<name>.py`` written against the port's API, with its steps,
prints and asserts. Each runs on the card unless the caller asks for
the CPU: its ``main(device="cuda")`` makes the port's default backend,
``torch_auto``, on that device the active one for the run.
"""
from __future__ import annotations

import argparse
import contextlib

__all__ = ["device_arg", "on_device"]


def device_arg(doc: str, argv=None) -> str:
    """The ``--device`` of an entry point's command line (default
    ``cuda``)."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="the card, or cpu (default: cuda)")
    return ap.parse_args(argv).device


@contextlib.contextmanager
def on_device(device: str):
    """``torch_auto`` on ``device`` as the active backend; raises when
    ``device`` is ``cuda`` and no card is there."""
    from repro_torch import exec as exec_backends
    from repro_torch.exec.torch_auto import TorchAutoBackend
    with exec_backends.use_backend(TorchAutoBackend(device=device)) as be:
        yield be
