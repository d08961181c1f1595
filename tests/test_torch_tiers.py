"""The port's tier stores (``repro_torch.core.tiers``) against the
reference's (``repro.core.tiers``): a payload already read, or already
handed to a store, does not change when a later write reuses the hot
slot or when the caller changes its own tensor.

The reference's payloads are immutable jax arrays; the port's hot slab is
written in place, so it has to copy on read (and the cold store on put)
to give the same answers. Exact comparisons.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import placement as r_place
from repro.core import tiers as r_tiers
from repro_torch.core import placement as t_place
from repro_torch.core import tiers as t_tiers


def stores():
    """(reference, port) two-tier stores whose policy writes every doc to
    the hot tier, with a one-slot hot slab."""
    ref = r_tiers.TieredStore(r_place.all_tier_a(10**6),
                              r_tiers.HotTier(1, (2,), dtype=jnp.int32),
                              r_tiers.ColdTier())
    port = t_tiers.TieredStore(t_place.all_tier_a(10**6),
                               t_tiers.HotTier(1, (2,), dtype=torch.int32,
                                               device="cpu"),
                               t_tiers.ColdTier())
    return ref, port


def as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("read", ["read_all", "read"])
def test_payload_read_survives_a_write_that_reuses_its_slot(read):
    """write(0, [1, 1]); read; evict(0); write(1, [7, 7]): the payload read
    first is still [1, 1], as the reference's is."""
    got = {}
    for name, store, mk in (("ref", stores()[0], jnp.asarray),
                            ("port", stores()[1], torch.tensor)):
        store.write(0, mk(np.array([1, 1], np.int32)))
        got[name] = (store.read_all([0])[0] if read == "read_all"
                     else store.read(0))
        store.evict(0)
        store.write(1, mk(np.array([7, 7], np.int32)))
        np.testing.assert_array_equal(as_np(store.read(1)), [7, 7])
    np.testing.assert_array_equal(as_np(got["ref"]), [1, 1])
    np.testing.assert_array_equal(as_np(got["port"]), [1, 1])


def test_hot_tier_get_is_a_copy_of_its_slot():
    hot = t_tiers.HotTier(2, (3,), dtype=torch.float32, device="cpu")
    hot.put(5, np.array([1.0, 2.0, 3.0], np.float32))
    a = hot.get(5)
    a += 10  # a caller writing into what it read leaves the slot alone
    hot.put(5, np.array([4.0, 5.0, 6.0], np.float32))  # same slot, rewritten
    np.testing.assert_array_equal(a.numpy(), [11.0, 12.0, 13.0])
    np.testing.assert_array_equal(hot.get(5).numpy(), [4.0, 5.0, 6.0])


@pytest.mark.parametrize("spill", [False, True])
def test_cold_tier_keeps_its_own_copy_of_a_tensor(spill, tmp_path):
    """The caller changes its CPU tensor after ``put``; what the cold tier
    holds does not change (a jax array cannot change in the
    reference)."""
    directory = str(tmp_path) if spill else None
    port = t_tiers.ColdTier(directory)
    ref = r_tiers.ColdTier(str(tmp_path / "ref") if spill else None)
    payload = torch.tensor([3, 4, 5], dtype=torch.int32)
    assert port.put(9, payload) == ref.put(
        9, jnp.asarray(np.array([3, 4, 5], np.int32)))
    payload[:] = -1
    np.testing.assert_array_equal(port.get(9), [3, 4, 5])
    np.testing.assert_array_equal(port.get(9), np.asarray(ref.get(9)))


def test_migrated_payload_is_not_aliased_to_the_hot_slot():
    """A doc moved hot → cold by the cascade keeps its payload when the
    freed hot slot is written again."""
    got = {}
    for name, place, tiers, kw, mk in (
            ("ref", r_place, r_tiers, {"dtype": jnp.int32}, jnp.asarray),
            ("port", t_place, t_tiers, {"dtype": torch.int32,
                                        "device": "cpu"}, torch.tensor)):
        pol = place.Policy(r=2.0, migrate_at_r=True)
        store = tiers.TieredStore(pol, tiers.HotTier(1, (2,), **kw),
                                  tiers.ColdTier())
        store.write(0, mk(np.array([1, 2], np.int32)))
        store.maybe_migrate(2)  # the doc moves to the cold tier
        store.write(1, mk(np.array([8, 9], np.int32)))
        got[name] = {d: as_np(p) for d, p in store.read_all([0, 1]).items()}
        assert store.tier_index_of(0) == 1
    for d in (0, 1):
        np.testing.assert_array_equal(got["port"][d], got["ref"][d])
    np.testing.assert_array_equal(got["port"][0], [1, 2])
