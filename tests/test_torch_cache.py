"""The bounded LRU of the port's host work (``dgdm_tpu_torch/core/cache.py``),
which keeps the 2D finger work, the 3D gripper masses and height grids and
the 3D surface fits: a hit becomes the newest entry, a miss into a full map
evicts the oldest, and a batch is returned whole before anything of it is
evicted. No JAX counterpart."""

from dgdm_tpu_torch.core.cache import LRU
from dgdm_tpu_torch.sim import engine2d, engine3d, rollout3d


def _made(log, value):
    def make():
        log.append(value)
        return value
    return make


def test_get_makes_on_a_miss_and_evicts_the_least_recent():
    lru, log = LRU(2), []
    assert lru.get(b"a", _made(log, 1)) == 1
    assert lru.get(b"b", _made(log, 2)) == 2
    assert lru.get(b"a", _made(log, 9)) == 1      # a hit: a is now newest
    assert log == [1, 2]
    assert lru.get(b"c", _made(log, 3)) == 3      # evicts b, not a
    assert len(lru) == 2 and b"a" in lru and b"b" not in lru
    assert lru.get(b"b", _made(log, 4)) == 4      # made anew, evicts a
    assert b"a" not in lru and log == [1, 2, 3, 4]


def test_a_failed_make_leaves_the_map_as_it_was():
    lru = LRU(1)
    lru.get(b"a", lambda: 1)

    def fail():
        raise ValueError("no value")

    try:
        lru.get(b"b", fail)
    except ValueError:
        pass
    assert b"a" in lru and b"b" not in lru and len(lru) == 1


def test_get_many_makes_the_misses_in_one_call_and_evicts_after():
    lru, calls = LRU(3), []

    def make(miss):
        calls.append(list(miss))
        return [10 * i for i in miss]

    assert lru.get_many([b"a", b"b"], make) == [0, 10]
    # b hits, c and d miss together; the batch of three comes back whole,
    # then the oldest (a) goes
    assert lru.get_many([b"c", b"b", b"d"], make) == [0, 10, 20]
    assert calls == [[0, 1], [0, 2]]
    assert [k for k in (b"a", b"b", b"c", b"d") if k in lru] == \
        [b"b", b"c", b"d"]
    # a batch larger than the capacity is returned whole, then trimmed to
    # its newest entries
    assert lru.get_many([b"e", b"f", b"g", b"h"], make) == [0, 10, 20, 30]
    assert len(lru) == 3 and b"e" not in lru and b"h" in lru


def test_the_caches_keep_their_capacities():
    assert engine2d._FINGER_CACHE_2D.capacity == 4096
    assert engine3d._GRIP_CACHE.capacity == 1024
    assert engine3d._HGRID_CACHE.capacity == 1024
    assert rollout3d._FIT_CACHE.capacity == 2048
