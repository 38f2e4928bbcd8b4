"""Memoization aspects (paper §2.4, Figs. 8–9).

The paper wraps pure C/C++ functions with a lookup table.  The port's
equivalents are host-level: serving request caches, built-step caches, and
DSE-result caches.  The aspect exposes the same
surface as the paper's Memoize_Method: table size, replacement policy,
approximation bits (float-key quantization), persistence files, full
offline mode, and a runtime stop/run toggle — all implemented by
repro_torch.memo.table.MemoTable.
"""

from __future__ import annotations

from typing import Any

from repro_torch.core.weaver import Aspect, Weaver
from repro_torch.memo.table import MemoTable


class MemoizeStep(Aspect):
    """Wrap the (pure) serve step with a MemoTable keyed on request content."""

    name = "Memoize_Method"

    def __init__(
        self,
        *,
        tsize: int = 65536,
        replace: bool = True,
        approx_bits: int = 0,
        file_to_load: str | None = None,
        file_to_save: str | None = None,
        full_offline: bool = False,
    ):
        self.table = MemoTable(
            size=tsize,
            replace=replace,
            approx_bits=approx_bits,
            load_path=file_to_load,
            save_path=file_to_save,
            full_offline=full_offline,
        )

    def apply(self, weaver: Weaver) -> None:
        steps = weaver.select(kind="step").where(lambda j: j.attr("step") == "serve_step")
        if not len(steps.all()):
            steps = weaver.select(kind="step")
        from repro_torch.monitor.sensors import memo_wrapper

        weaver.set_extra("memo_table", self.table)
        weaver.wrap_step(memo_wrapper(self.table))


def find_memoizable(weaver: Weaver) -> list[str]:
    """The paper's 'automatically detect memoizable functions': any pure
    joinpoint without per-call randomness or mutable state is eligible."""
    out = []
    for jp in weaver.select():
        if jp.kind in ("embedding", "norm", "mlp"):  # deterministic, side-effect-free
            out.append(jp.path)
    return out
