"""BSP cost accounting (Valiant's W, H, S — paper §4): the port of
`repro.bsp.counters`, copied (it has no array code).

`suffix_array_bsp` logs one superstep per barrier, with analytic per-superstep h
(max words in + max words out per processor) and w (local work estimate).
The same accounting doubles as a pure cost model:
`repro_torch.bsp.suffix_array.estimate_costs` replays its
superstep schedule for arbitrary (n, p) without executing anything (SM1 =
11, SM2 = 9 supersteps a round, plus one base gather: S = 20·rounds + 1).
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class BSPCounters:
    supersteps: int = 0
    comm_words: int = 0          # H = Σ_s h_s
    work: int = 0                # W = Σ_s w_s
    log: list = field(default_factory=list)
    enabled: bool = True

    def superstep(self, label: str, *, h: int = 0, w: int = 0) -> None:
        if not self.enabled:
            return
        self.supersteps += 1
        self.comm_words += int(h)
        self.work += int(w)
        self.log.append({"label": label, "h": int(h), "w": int(w)})

    @property
    def rounds(self) -> int:
        """Completed distributed SM1/SM2 rounds (recursion levels that ran
        on the mesh, excluding the sequential base)."""
        return sum(1 for e in self.log if e["label"] == "SM1/halo")

    def summary(self) -> dict:
        return {"S": self.supersteps, "H": self.comm_words, "W": self.work,
                "rounds": self.rounds}


NULL_COUNTERS = BSPCounters(enabled=False)
