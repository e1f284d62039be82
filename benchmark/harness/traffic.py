"""The one generator of requests. A traffic file (``traffic/<name>.json``)
gives its parameters; request i of a run comes from ``numpy``'s generator
seeded with (run seed, i), so the same seed gives the same requests, and
every seed the same sizes.

Text-to-image parameters: ``steps``, ``sampler``, ``cfg_scale``, ``turbo``,
``prompt_words`` and ``negative_prompt_words`` ([fewest, most] words), and
``vocabulary``: ``size`` words made of two to three letter pairs, with ids
spread evenly over [``first_id``, ``last_id``]. ``check_requests`` and
``traced_requests`` say how many requests the check and the profiler take.

Every cell runs one client in a closed loop at batch 1 (``harness/main.py``):
a file that names any other key is refused, so that a parameter the harness
does not implement cannot pass unseen."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

KEYS = frozenset({"steps", "sampler", "cfg_scale", "turbo", "prompt_words", "negative_prompt_words", "vocabulary",
                  "check_requests", "traced_requests"})
CONSONANTS = "bcdfghjklmnprstvz"
VOWELS = "aeiou"


def vocabulary(params: dict) -> Dict[str, int]:
    """word -> token id; the same table for every run of a traffic file."""
    v = params["vocabulary"]
    syll = [c + w for c in CONSONANTS for w in VOWELS]
    words = [a + b for a in syll for b in syll] + [a + b + c for a in syll[:20] for b in syll for c in syll[:20]]
    order = np.random.default_rng(0).permutation(len(words))[: int(v["size"])]
    ids = np.linspace(int(v["first_id"]), int(v["last_id"]), int(v["size"])).astype(np.int64)
    return {words[j]: int(i) for j, i in zip(order, ids)}


def _words(rng: np.random.Generator, vocab: List[str], span) -> str:
    n = int(rng.integers(int(span[0]), int(span[1]) + 1))
    return " ".join(vocab[k] for k in rng.integers(0, len(vocab), n))


def request(params: dict, seed: int, index: int, vocab: List[str]) -> dict:
    """Request ``index`` of a run seeded with ``seed``."""
    rng = np.random.default_rng([int(seed) & ((1 << 64) - 1), int(index)])
    return {"index": index, "prompt": _words(rng, vocab, params["prompt_words"]),
            "negative_prompt": _words(rng, vocab, params["negative_prompt_words"]),
            "seed": int(rng.integers(0, 1 << 31)), "steps": int(params["steps"]), "sampler": params["sampler"],
            "cfg_scale": float(params["cfg_scale"]), "turbo": bool(params.get("turbo", False))}


class Requests:
    """The run's requests, in order."""

    def __init__(self, params: dict, seed: int):
        unknown = sorted(set(params) - KEYS)
        if unknown:
            raise ValueError(f"traffic keys {unknown} are not implemented by the generator (it reads {sorted(KEYS)})")
        self.params, self.seed = params, seed
        self.vocab = vocabulary(params)
        self._words = sorted(self.vocab)

    def __getitem__(self, index: int) -> dict:
        return request(self.params, self.seed, index, self._words)
