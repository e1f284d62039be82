"""The request generator: the same seed gives the same requests, every seed
the same sizes, and large seeds work."""

import json
import os

import pytest

from benchmark.harness.traffic import Requests, vocabulary
from benchmark.reference.pipeline import tokens

TRAFFIC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "traffic")


def _load(name):
    with open(os.path.join(TRAFFIC, name + ".json")) as f:
        return json.load(f)


def test_same_seed_same_requests():
    for name in ("euler_a-10", "turbo-1step"):
        p = _load(name)
        a, b = Requests(p, 2 ** 32 + 17), Requests(p, 2 ** 32 + 17)
        assert [a[i] for i in range(20)] == [b[i] for i in range(20)]
        c = Requests(p, 5)
        assert [a[i]["prompt"] for i in range(20)] != [c[i]["prompt"] for i in range(20)]


def test_every_seed_same_sizes():
    p = _load("euler_a-10")
    for seed in (0, 1, 2 ** 31 + 3, 2 ** 33):
        reqs = Requests(p, seed)
        for i in range(30):
            r = reqs[i]
            assert (r["steps"], r["sampler"], r["cfg_scale"], r["turbo"]) == (10, "euler_a", 7.5, False)
            n = len(r["prompt"].split())
            assert p["prompt_words"][0] <= n <= p["prompt_words"][1]
            assert 0 <= r["seed"] < 2 ** 31


@pytest.mark.parametrize("key,value", [("batch", 4), ("clients", 2), ("loop", "open")])
def test_unimplemented_key_is_refused(key, value):
    with pytest.raises(ValueError, match=key):
        Requests({**_load("euler_a-10"), key: value}, 1)


def test_turbo_has_no_negative_prompt():
    reqs = Requests(_load("turbo-1step"), 9)
    assert all(reqs[i]["negative_prompt"] == "" and reqs[i]["turbo"] and reqs[i]["steps"] == 1 for i in range(10))


def test_vocabulary_fixed_and_in_range():
    p = _load("euler_a-10")
    v = vocabulary(p)
    assert v == vocabulary(p) and len(v) == p["vocabulary"]["size"]
    assert all(w.isalpha() and w.islower() for w in v)
    ids = sorted(v.values())
    assert ids[0] >= 300 and ids[-1] < 49406 and len(set(ids)) == len(ids)


def test_prompt_tokens_layout():
    p = _load("euler_a-10")
    v = vocabulary(p)
    r = Requests(p, 3)[0]
    t = tokens(r["prompt"], v)
    n = len(r["prompt"].split())
    assert t.shape == (1, 77) and t[0, 0] == 49406
    assert [int(x) for x in t[0, 1:n + 1]] == [v[w] for w in r["prompt"].split()]
    assert (t[0, n + 1:] == 49407).all()
