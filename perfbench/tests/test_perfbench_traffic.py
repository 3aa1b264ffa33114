"""The design traffic never repeats a request: every request draws fresh
noise, whole blocks hold the balanced schedule, and every seed sends the
same requests of a whole block in another order."""

import torch

from perfbench import harness
from perfbench.tests import small


class _Done(Exception):
    pass


def _sent(seed, count):
    """The (key, objective, object, noise) of the first ``count`` requests
    of a window, with the requests themselves left out."""
    cell = small.design_cell()
    traffic = harness.traffic_class(cell)(cell, seed, small.CPU)
    traffic.setup()
    sent = []

    def record(key, obj_i, oi, record=True):
        sent.append((key, obj_i, oi, traffic._noise(key)))
        if len(sent) == count:
            raise _Done

    traffic._request = record
    try:
        traffic.window(3600.0)
    except _Done:
        pass
    traffic.finish()
    return traffic, sent


def test_no_request_repeats_and_blocks_are_balanced():
    traffic, sent = _sent(2 ** 31 + 77, 15)
    size = len(traffic.schedule)
    keys = [k for k, _, _, _ in sent]
    assert len(set(keys)) == len(keys)
    noises = torch.stack([n for _, _, _, n in sent]).flatten(1)
    assert torch.unique(noises, dim=0).shape[0] == len(sent)
    for b in range(len(sent) // size):
        block = sent[b * size:(b + 1) * size]
        assert sorted(k[1] for k, _, _, _ in block) == list(range(size))
        assert sorted((o, j) for _, o, j, _ in block) == \
            sorted(traffic.schedule)


def test_seeds_send_the_same_blocks_in_another_order():
    size = small.design_cell().params["block"]
    _, a = _sent(5, 2 * size)
    _, b = _sent(2 ** 32 + 5, 2 * size)
    assert [k for k, *_ in a] != [k for k, *_ in b]
    first = {k: n for k, _, _, n in a}
    for k, _, _, n in b:
        assert torch.equal(first[k], n)
