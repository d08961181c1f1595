"""The port's sharding rules (``repro_torch.parallel.ctx`` and
``sharding``) against the reference's ``repro.parallel``: every config's
parameter, optimizer, batch and cache specs on both production meshes,
each shape of ``SHAPES``, with FSDP and without, equal to the
reference's ``NamedSharding.spec``. The reference's side is built on
``jax.sharding.AbstractMesh`` (no devices).

The port's trees are unstacked: a group's layers are a list of
per-layer dicts where the reference stacks them on a leading axis, so a
layer's spec must be the reference's stacked spec without its leading
``None``, and the per-chip bytes, summed over the layers, must be the
reference's (exact: the rules leave no padding). ``resolve``'s
fallbacks are held by hand.
"""
import functools
import math

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as r_configs
from repro.launch import specs as r_specs
from repro.models import lm as r_lm
from repro.parallel import ctx as r_ctx
from repro.parallel import sharding as r_shd
from repro.runtime import steps as r_steps
from repro_torch import configs as t_configs
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import specs as t_specs
from repro_torch.models import lm as t_lm
from repro_torch.parallel import ctx as t_ctx
from repro_torch.parallel import sharding as t_shd
from repro_torch.runtime import steps as t_steps

ARCHS = list(r_configs.list_archs())
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


@functools.lru_cache(maxsize=None)
def ref_mesh(kind):
    return AbstractMesh(*MESHES[kind])


def port_mesh(kind):
    return t_mesh.make_production_mesh(multi_pod=kind == "multi")


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    return r_lm.abstract_params(r_configs.get_config(arch))


@functools.lru_cache(maxsize=None)
def ref_cache(arch, shape_name):
    return r_specs.decode_inputs(r_configs.get_config(arch),
                                 r_configs.get_shape(shape_name))[1]


def norm(spec, ndim):
    """A spec as a tuple of ``ndim`` entries (a PartitionSpec may drop
    trailing Nones)."""
    entries = tuple(spec)
    return entries + (None,) * (ndim - len(entries))


def ref_local_bytes(mesh, spec, shape, itemsize):
    n = 1
    for d, e in zip(shape, norm(spec, len(shape))):
        s = r_ctx.axis_size(mesh, e)
        assert d % s == 0
        n *= d // s
    return n * itemsize


def get(node, key):
    return node[key] if isinstance(node, (dict, list)) else getattr(node, key)


def compare_stacked(port_tree, port_specs, ref_tree, ref_shardings, mesh,
                    rmesh, stacked_at):
    """Walk the port's tree; a leaf under a stacked group (its path's
    ``stacked_at``-th entry, after the group's, is the layer index) is
    held to the reference's stacked leaf less its leading None. Returns
    (port bytes, reference bytes) a chip; each reference leaf is counted
    once."""
    port_bytes, ref_bytes, seen = 0, 0, set()

    def walk(node, spec, path):
        nonlocal port_bytes, ref_bytes
        if isinstance(node, dict):
            for k in node:
                walk(node[k], spec[k], path + (k,))
            return
        if isinstance(node, (list, tuple)) and not isinstance(
                node, torch.Tensor):
            fields = getattr(node, "_fields", None)
            for i, (n, s) in enumerate(zip(node, spec)):
                walk(n, s, path + ((fields[i] if fields else i),))
            return
        stacked = stacked_at is not None and len(path) > stacked_at and \
            path[0] in ("dec", "enc", "groups")
        rpath = (path[:stacked_at] + path[stacked_at + 1:] if stacked
                 else path)
        rleaf, rsh = ref_tree, ref_shardings
        for k in rpath:
            rleaf, rsh = get(rleaf, k), get(rsh, k)
        if not isinstance(node, torch.Tensor):  # the cache's position
            assert tuple(rsh.spec) == () and spec == ()
            port_bytes += 4
            ref_bytes += 4
            return
        rspec = norm(rsh.spec, len(rleaf.shape))
        want = rspec[1:] if stacked else rspec
        assert tuple(spec) == want, (path, spec, want)
        assert tuple(node.shape) == tuple(rleaf.shape[1:] if stacked
                                          else rleaf.shape), path
        port_bytes += math.prod(t_shd.local_shape(mesh, spec, node.shape)) \
            * node.element_size()
        if rpath not in seen:
            seen.add(rpath)
            ref_bytes += ref_local_bytes(rmesh, rspec, rleaf.shape,
                                         np.dtype(rleaf.dtype).itemsize)

    walk(port_tree, port_specs, ())
    return port_bytes, ref_bytes


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "tp_only"])
@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mesh_kind, fsdp):
    rmesh, mesh = ref_mesh(mesh_kind), port_mesh(mesh_kind)
    rparams = ref_params(arch)
    rsh = r_shd.param_shardings(rmesh, rparams, fsdp=fsdp)
    params = t_lm.abstract_params(t_configs.get_config(arch))
    specs = t_shd.param_specs(mesh, params, fsdp=fsdp)
    got, want = compare_stacked(params, specs, rparams, rsh, mesh, rmesh, 2)
    assert got == want == t_shd.local_bytes(mesh, params, specs)


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_specs_match_reference(arch, mesh_kind):
    rmesh, mesh = ref_mesh(mesh_kind), port_mesh(mesh_kind)
    rcfg = r_configs.get_config(arch)
    ropt = r_steps.abstract_train_state(rcfg).opt
    rsh = r_shd.opt_shardings(rmesh, ropt)
    opt = t_steps.abstract_train_state(t_configs.get_config(arch)).opt
    specs = t_shd.opt_specs(mesh, opt)
    assert specs.step == () and tuple(rsh.step.spec) == ()
    for part in ("m", "v"):
        got, want = compare_stacked(getattr(opt, part), getattr(specs, part),
                                    getattr(ropt, part), getattr(rsh, part),
                                    mesh, rmesh, 2)
        assert got == want


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("shape_name", list(r_configs.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_reference(arch, shape_name, mesh_kind):
    rmesh, mesh = ref_mesh(mesh_kind), port_mesh(mesh_kind)
    rcfg, cfg = r_configs.get_config(arch), t_configs.get_config(arch)
    rshape, shape = r_configs.get_shape(shape_name), \
        t_configs.get_shape(shape_name)
    rbatch = r_specs.batch_specs(rcfg, rshape)
    rb_sh = r_shd.batch_shardings(rmesh, rbatch)
    batch = t_specs.batch_specs(cfg, shape)
    b_sp = t_shd.batch_specs(mesh, batch)
    assert set(batch) == set(rbatch)
    for k in batch:
        assert b_sp[k] == norm(rb_sh[k].spec, batch[k].ndim), k
        assert tuple(batch[k].shape) == tuple(rbatch[k].shape)
    rcache = ref_cache(arch, shape_name)
    rc_sh = r_shd.cache_shardings(rmesh, rcache)
    tok, cache = t_specs.decode_inputs(cfg, shape)
    c_sp = t_shd.cache_specs(mesh, cache)
    # a cache group is [layer caches]; the reference's leaf is stacked
    got, want = compare_stacked(cache, c_sp, rcache, rc_sh, mesh, rmesh, 2)
    assert got == want == t_shd.local_bytes(mesh, cache, c_sp)


def test_resolve_fallbacks_by_hand():
    multi, single = port_mesh("multi"), port_mesh("single")
    # B=16 on pod×data=32 → the shrinking prefix: pod (2) divides 16
    assert t_ctx.resolve(multi, t_ctx.BATCH, 16) == "pod"
    assert t_ctx.resolve(multi, t_ctx.BATCH, 32) == ("pod", "data")
    assert t_ctx.resolve(multi, t_ctx.BATCH, 1) is None
    assert t_ctx.resolve(single, t_ctx.BATCH, 16) == "data"
    # 8 KV heads on a 16-way model axis: replicated
    assert t_ctx.resolve(single, t_ctx.MODEL, 8) is None
    assert t_ctx.resolve(single, t_ctx.MODEL, 32) == "model"
    assert t_ctx.spec(single, (None, None, t_ctx.MODEL, None),
                      (4, 1024, 8, 128)) == (None, None, None, None)
    # an axis appears once: the second dimension stays replicated
    assert t_ctx.spec(single, ("model", "model"), (32, 32)) == ("model", None)
    # the same on the reference
    rm, rs = ref_mesh("multi"), ref_mesh("single")
    assert r_ctx.resolve(rm, r_ctx.BATCH, 16) == "pod"
    assert r_ctx.resolve(rs, r_ctx.MODEL, 8) is None


@pytest.mark.parametrize("dims", [(16, 16), (2, 16, 16), (2, 4), (1, 1)])
def test_resolve_and_spec_match_reference_on_a_grid(dims):
    names = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    rmesh = AbstractMesh(dims, names)
    mesh = t_ctx.LogicalMesh(dims, names)
    assert mesh.size == math.prod(dims)
    markers = [None, t_ctx.BATCH, t_ctx.MODEL, t_ctx.SEQ, "data",
               ("pod", "data"), "pod"]
    for m in markers:
        for n in (1, 2, 3, 8, 16, 24, 32, 48, 512):
            assert t_ctx.resolve(mesh, m, n) == r_ctx.resolve(rmesh, m, n)
    for shape in ((32, 16, 8), (1, 4096, 8), (64, 2, 16)):
        ms = (t_ctx.BATCH, t_ctx.SEQ, t_ctx.MODEL)
        assert t_ctx.spec(mesh, ms, shape) == norm(
            r_ctx.spec(rmesh, ms, shape), 3)


def test_local_shape_refuses_an_indivisible_spec():
    mesh = port_mesh("single")
    assert t_shd.local_shape(mesh, ("data", None), (32, 7)) == (2, 7)
    with pytest.raises(ValueError, match="does not divide"):
        t_shd.local_shape(mesh, ("data",), (24,))


def test_host_mesh_clips_to_the_local_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = t_mesh.make_host_mesh(4, 2)
    assert m.shape == {"data": 1, "model": 1}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert t_mesh.make_host_mesh(4, 4).shape == {"data": 4, "model": 2}


def test_mesh_context():
    mesh = port_mesh("single")
    assert t_ctx.get_mesh() is None and t_ctx.tp_size() == 1
    with t_ctx.use_mesh(mesh) as m:
        assert m is mesh and t_ctx.get_mesh() is mesh
        assert t_ctx.tp_size() == 16
        assert t_ctx.dp_axes(mesh) == ("data",)
        with t_ctx.use_mesh(port_mesh("multi")):
            assert t_ctx.dp_axes(t_ctx.get_mesh()) == ("pod", "data")
        assert t_ctx.get_mesh() is mesh
    assert t_ctx.get_mesh() is None
    assert t_ctx.axis_size(mesh, ("data", "model")) == 256
    assert t_ctx.axis_size(mesh, None) == 1
