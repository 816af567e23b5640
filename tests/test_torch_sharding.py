"""Port parity: ``repro_torch.sharding`` and the mesh half of
``repro_torch.engine.plan`` against ``repro.sharding`` / ``repro.engine``.

Specs are compared as tuples: the port's spec is what
``tuple(jax.sharding.PartitionSpec)`` gives. The JAX rules take a duck-typed
mesh (``axis_names`` + ``devices.shape``), so the production shapes need no
devices on either side; the port plans them on the meta device. The grouped
MoE is held against JAX ``moe_ffn`` with its ambient mesh faked, as the
port's ``use_mesh`` installs one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.configs.base import param_axes as jparam_axes
from repro.engine import api as japi
from repro.engine import plan as jplan
from repro.launch import mesh as jmesh
from repro.models import moe as jmoe
from repro.sharding import rules as jrules
from repro_torch import configs as tcfg
from repro_torch.configs.base import SHAPES, InputShape
from repro_torch.configs.base import param_axes as tparam_axes
from repro_torch.convert import params_from_jax
from repro_torch.engine import api as tapi
from repro_torch.engine import plan as tplan
from repro_torch.launch import mesh as tmesh
from repro_torch.models import moe as tmoe
from repro_torch.sharding import rules as trules

torch.set_num_threads(1)

ARCHS = sorted(jcfg.REGISTRY)
MESHES = {"1x1": (("data", "model"), (1, 1)),
          "2x2": (("data", "model"), (2, 2)),
          "16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


class Duck:
    """A mesh by names and shape for the JAX rules (planning needs axes
    only)."""

    def __init__(self, names, shape):
        self.axis_names = names
        self.devices = np.empty(shape)


def meshes(name):
    names, shape = MESHES[name]
    return Duck(names, shape), trules.AbstractMesh(names, shape)


def jspec(sharding_or_spec):
    spec = getattr(sharding_or_spec, "spec", sharding_or_spec)
    return tuple(spec)


def jleaves(tree):
    return jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))


@pytest.fixture(scope="module")
def axes():
    return {a: (jparam_axes(jcfg.get(a).api()),
                tparam_axes(tcfg.get(a).api())) for a in ARCHS}


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_specs_match_jax_for_every_leaf(axes, mesh_name):
    """Every param leaf of all ten archs, on each mesh, FSDP rules
    included."""
    duck, abstract = meshes(mesh_name)
    for arch in ARCHS:
        jax_axes, port_axes = axes[arch]
        jr = jrules.rules_for_arch(arch, mesh=duck)
        tr = trules.rules_for_arch(arch, mesh=abstract)
        assert tr == jr
        want = [jspec(jrules.spec_for(a, duck, jr)) for a in
                jax.tree.leaves(jax_axes, is_leaf=jplan._is_axes_leaf)]
        got = trules.axes_leaves(trules.tree_specs(port_axes, abstract, tr))
        assert got == want, (arch, mesh_name)
        assert trules.axes_leaves(port_axes) == jax.tree.leaves(
            jax_axes, is_leaf=jplan._is_axes_leaf), arch


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_placement_verdict_matches_jax(mesh_name):
    duck, abstract = meshes(mesh_name)
    for arch in ARCHS:
        for kernels in ("off", "auto", "on"):
            assert tapi.kernel_placement_ok(kernels, arch, abstract) == \
                japi.kernel_placement_ok(kernels, arch, duck), (arch, kernels)
            assert tapi.kernel_placement_ok(kernels, tcfg.get(arch), abstract) \
                == japi.kernel_placement_ok(kernels, jcfg.get(arch), duck)


def test_rules_helpers_match_jax():
    for name in MESHES:
        duck, abstract = meshes(name)
        assert trules.data_extent(abstract) == jrules.data_extent(duck)
        assert trules.model_extent(abstract) == jmesh.model_extent(duck)
        assert trules.worker_axes(abstract) == jrules.worker_axes(duck)
        assert trules.batch_spec(abstract) == jspec(jrules.batch_spec(duck))
        for fsdp in (False, True):
            assert trules.strip_data(trules.rules_for(fsdp)) == \
                jrules.strip_data(jrules.rules_for(fsdp))
    # The even-division fallback: a batch the data extent does not divide
    # replicates.
    odd = dataclasses.replace(SHAPES["long_500k"], global_batch=3)
    duck, abstract = meshes("2x2")
    assert trules.rules_for_arch("deepseek-7b", odd, abstract)["batch"] \
        is None
    assert jrules.rules_for_arch("deepseek-7b", odd, duck)["batch"] is None
    assert trules.pad_to_multiple(13, 8) == jrules.pad_to_multiple(13, 8)
    assert trules.rules_for(extra={"seq": "model"})["seq"] == "model"


def test_placements_and_production_meshes():
    from torch.distributed.tensor import Replicate, Shard
    prod = tmesh.make_production_mesh()
    multi = tmesh.make_production_mesh(multi_pod=True)
    for mine, theirs in ((prod, (("data", "model"), (16, 16))),
                         (multi, (("pod", "data", "model"), (2, 16, 16)))):
        assert (mine.axis_names, mine.shape) == theirs
    assert tmesh.model_extent(prod) == 16 and trules.data_extent(multi) == 32
    assert trules.placements((("pod", "data"), None, "model"), multi) == [
        Shard(0), Shard(0), Shard(2)]
    assert trules.placements((None,), prod) == [Replicate(), Replicate()]
    with pytest.raises(ValueError, match="twice"):
        trules.placements(("model", "model"), prod)


def test_ambient_mesh_and_constraints():
    prod = tmesh.make_production_mesh()
    assert trules.ambient_mesh() is None
    x = torch.ones(4, 4)
    with trules.use_mesh(prod):
        assert trules.ambient_mesh() is prod
        with trules.use_mesh(None):
            assert trules.ambient_mesh() is None
        # A plain tensor (a rank's local rows) is left alone.
        assert trules.ambient_constraint(x, "data", "UNC") is x
        assert trules.constraint(x, prod, "batch", None) is x
    assert trules.ambient_mesh() is None


def test_parse_host_mesh_without_a_process_group(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    assert tmesh.parse_host_mesh("1x1") is None
    with pytest.raises(SystemExit, match="DATAxMODEL"):
        tmesh.parse_host_mesh("four")
    with pytest.raises(SystemExit, match=">= 1"):
        tmesh.parse_host_mesh("0x2")
    with pytest.raises(RuntimeError, match="torchrun"):
        tmesh.parse_host_mesh("2x2")
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_host_mesh(2, 1, device="cpu")


def test_the_mesh_defaults_to_the_card(monkeypatch):
    """Under torchrun, ``--mesh`` without ``--cpu`` asks for the card (the
    train and serve CLIs alike): on a host without CUDA it raises up front
    instead of building a CPU mesh."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.parse_host_mesh("2x1")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.init_process_group()
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "deepseek-7b", "--reduced", "--mesh", "2x1"])
    assert tmesh.backend_for("cpu") == "gloo"
    assert tmesh.backend_for("cuda") == "nccl"


# -- train plans -------------------------------------------------------------------

PLAN_CASES = {
    "sync": dict(mode="sync"),
    "sync-kernels": dict(mode="sync", kernels="on"),
    "stale-psum": dict(mode="stale-psum", stale_s=2),
    "stale-psum-packed": dict(mode="stale-psum", stale_s=2, kernels="on"),
    "stale-psum-aggregate": dict(mode="stale-psum", stale_s=2,
                                 per_worker_delays=False),
    "stale-psum-topk": dict(mode="stale-psum", stale_s=2, kernels="on",
                            compress="topk:0.1"),
    "ssp": dict(mode="ssp", stale_s=2),
    "simulate": dict(mode="simulate", stale_s=2),
    "simulate-packed": dict(mode="simulate", stale_s=2, kernels="on"),
    "simulate-topk": dict(mode="simulate", stale_s=2, compress="topk:0.1"),
}


def _fields(state):
    inner = state.inner
    names = [f for f in ("params", "opt_state", "gbuf", "caches", "pending")
             if hasattr(inner, f)]
    return {n: getattr(inner, n) for n in names}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_train_plan_specs_match_jax_at_1x1(case):
    """The port's train-plan specs equal JAX ``attach_train_plan``'s
    ``in_shardings`` leaf for leaf (reduced deepseek-7b, P = 4)."""
    kw = dict(PLAN_CASES[case])
    shape = SHAPES["train_4k"]
    jeng = jplan.make_train_engine("deepseek-7b", shape,
                                   jmesh.make_host_mesh(1, 1), reduced=True,
                                   num_workers=4, **kw)
    teng = tplan.make_train_engine("deepseek-7b", shape,
                                   trules.AbstractMesh(("data", "model"),
                                                       (1, 1)),
                                   reduced=True, num_workers=4, **kw)
    jst, jb = jeng.plan().in_shardings
    tst, tb = teng.plan().in_shardings
    jf, tf = _fields(jst), _fields(tst)
    assert set(jf) == set(tf)
    if case == "sync-kernels":
        # The port's fused sync keeps its Adam moments packed ([D], which
        # mixes leaves, so they replicate); the JAX package keeps them per
        # leaf.
        assert trules.axes_leaves(tf.pop("opt_state")) == [(), (), ()]
        jf.pop("opt_state")
    for name in jf:
        assert trules.axes_leaves(tf[name]) == [jspec(s) for s in
                                                jleaves(jf[name])], name
    assert trules.axes_leaves(tst.comp) == [jspec(s) for s in
                                            jleaves(jst.comp)]
    assert tb == {k: jspec(v) for k, v in jb.items()}
    assert tst.bound == jspec(jst.bound)
    if hasattr(jst.inner, "update_state"):
        # The port keeps the workers' shared step count as one Python int
        # (replicated, where JAX holds P copies); every tensor leaf matches.
        structs = tm_leaves(teng.plan().args[0].inner.update_state)
        tl = trules.axes_leaves(tst.inner.update_state)
        jl = [jspec(s) for s in jleaves(jst.inner.update_state)]
        assert len(structs) == len(tl) == len(jl)
        assert [t for t, x in zip(tl, structs) if torch.is_tensor(x)] == \
            [j for j, x in zip(jl, structs) if torch.is_tensor(x)]
    for key in ("engine_mode", "s", "workers", "kind", "mode", "donate"):
        assert teng.plan().meta[key] == jeng.plan().meta[key], key
    assert teng.plan().meta["kernels"]["delivery"] == \
        jeng.plan().meta["kernels"]["delivery"]


def tm_leaves(tree):
    from repro_torch import treemath as tm
    return tm.tree_leaves(tree)


@pytest.mark.parametrize("arch_id", sorted(trules.FSDP_ARCHS))
def test_fsdp_plans_build_on_the_meta_device(arch_id):
    """The full-size FSDP plans build abstractly on the production mesh:
    every argument is a meta tensor, params shard 'embed' over the data
    axis, and stale-psum takes the aggregate ring."""
    eng = tplan.make_train_engine(arch_id, "train_4k",
                                  tmesh.make_production_mesh(), stale_s=2)
    plan = eng.plan()
    leaves = [x for x in tm_leaves(plan.args) if torch.is_tensor(x)]
    assert leaves and all(x.device.type == "meta" for x in leaves)
    total = sum(x.numel() for x in tm_leaves(plan.args[0].inner.params))
    assert total > 1e10
    params = trules.axes_leaves(plan.in_shardings[0].inner.params)
    assert any("data" in str(s) for s in params)
    gbuf = trules.axes_leaves(plan.in_shardings[0].inner.gbuf)
    assert all(b[0] is None and b[1:] == p for b, p in zip(gbuf, params))
    assert eng.cfg.per_worker_delays is False
    with pytest.raises(ValueError, match="abstract mesh"):
        eng.init(0)
    # build() dispatches by kind to the same plan.
    again = tplan.build(arch_id, "train_4k", tmesh.make_production_mesh(),
                        stale_s=2)
    assert trules.axes_leaves(again.in_shardings[0].inner.params) == params


def test_delay_table_placement():
    duck, abstract = meshes("2x2")
    table = np.zeros((5, 4), np.int32)
    _, spec = tplan.place_delay_table(table, abstract)
    jspec_ = jspec(jax.sharding.PartitionSpec(None, jrules.worker_axes(duck)))
    assert spec == jspec_ == (None, "data")
    assert tplan.place_delay_table(np.zeros((5, 3)), abstract)[1] == ()
    assert tplan.place_delay_table(np.zeros(5), abstract)[1] == ()


def test_inference_plans_take_the_mesh_third():
    mesh = trules.AbstractMesh(("data", "model"), (2, 2))
    shape = InputShape("p", 16, 4, "prefill")
    plan = tplan.plan_prefill("deepseek-7b", shape, mesh, reduced=True)
    jp = jplan.plan_prefill("deepseek-7b", shape, jmesh.make_host_mesh(1, 1),
                            reduced=True)
    assert plan.meta == jp.meta
    assert plan.in_shardings[1] == {"tokens": ("data", None)}
    assert plan.out_shardings[0] == ("data", None, None)
    d = tplan.plan_decode("deepseek-7b", InputShape("d", 32, 4, "decode"),
                          mesh, reduced=True)
    assert d.in_shardings[1] == ("data", None) and d.in_shardings[3] == ()
    assert all(x.device.type == "meta" for x in tm_leaves(d.args[0]))
    # The serve step plans on a mesh too (A.16; its specs against JAX's in
    # test_serve_plan_specs_match_jax).
    layout = tlay(tcfg.get("deepseek-7b").api(reduced=True))
    s = tplan.plan_serve_step("deepseek-7b", InputShape("s", 32, 2, "decode"),
                              mesh, layout=layout, num_pages=1, reduced=True)
    assert s.in_shardings[1:] == ((),) * 8 and s.donate_argnums == (1, 2)
    assert all(x.device.type == "meta" for x in tm_leaves(s.args[0]))


SERVE_SHAPE = InputShape("serve_decode", 24, 2, "decode")


def tlay(api):
    from repro_torch.serving import build_layout
    return build_layout(api, SERVE_SHAPE.seq_len, 4, device="cpu")


@pytest.mark.parametrize("arch_id", ["deepseek-7b", "deepseek-67b",
                                     "qwen2-moe-a2.7b", "h2o-danube-1.8b"])
def test_serve_plan_specs_match_jax(arch_id):
    """The serve plan's spec trees (A.16): at 1x1 equal to JAX
    ``plan_serve_step``'s ``in_shardings`` / ``out_shardings`` and
    ``donate_argnums``; at 2x2 and 16x16 its params specs equal JAX's
    ``rules.spec_for`` under ``rules_for_arch`` (the model axis on the
    param dims, FSDP ``embed`` on data) and every other argument is
    replicated, as JAX's planner puts them."""
    from repro import serving as js
    japi = jcfg.get(arch_id).api(reduced=True)
    tapi = tcfg.get(arch_id).api(reduced=True)
    jlay = js.build_layout(japi, SERVE_SHAPE.seq_len, 4)
    tlayout = tlay(tapi)
    jp = jplan.plan_serve_step(arch_id, SERVE_SHAPE,
                               jmesh.make_host_mesh(1, 1), layout=jlay,
                               num_pages=12, reduced=True, paged="auto")
    tp = tplan.plan_serve_step(arch_id, SERVE_SHAPE,
                               trules.AbstractMesh(("data", "model"), (1, 1)),
                               layout=tlayout, num_pages=12, reduced=True,
                               paged="auto")
    assert trules.axes_leaves(tp.in_shardings[0]) == [
        jspec(x) for x in jleaves(jp.in_shardings[0])]
    assert list(tp.in_shardings[1:]) == [jspec(x) for x in
                                         jp.in_shardings[1:]]
    assert list(tp.out_shardings) == [jspec(x) for x in jp.out_shardings]
    assert tp.donate_argnums == jp.donate_argnums
    assert [tuple(x.shape) for x in tm_leaves(tp.args[1:7])] == \
        [tuple(x.shape) for x in jp.args[1:7]]
    # The port's meta adds the page pool's row width (a tensor-parallel
    # rank's is its own); the rest is JAX's.
    assert tp.meta.pop("pool_width") == tlayout.width
    assert tp.meta == jp.meta
    jaxes = jax.tree.leaves(jparam_axes(japi), is_leaf=jplan._is_axes_leaf)
    for name in ("2x2", "16x16"):
        duck, abstract = meshes(name)
        plan = tplan.plan_serve_step(arch_id, SERVE_SHAPE, abstract,
                                     layout=tlayout, num_pages=12,
                                     reduced=True, paged="auto")
        rules = jrules.rules_for_arch(arch_id, shape=SERVE_SHAPE, mesh=duck)
        assert trules.axes_leaves(plan.in_shardings[0]) == [
            jspec(jrules.spec_for(a, duck, rules)) for a in jaxes], name
        assert plan.in_shardings[1:] == ((),) * 8
        assert plan.out_shardings == ((),) * 3
        if arch_id in trules.FSDP_ARCHS:
            assert any("data" in str(x) for x in
                       trules.axes_leaves(plan.in_shardings[0]))


SERVE_MESHES = {"none": None, "1x1": (1, 1), "2x1": (2, 1), "1x2": (1, 2),
                "2x2": (2, 2)}


@pytest.fixture(scope="module")
def serve_layouts():
    from repro import serving as js
    out = {}
    for arch in ARCHS:
        japi = jcfg.get(arch).api(reduced=True)
        tapi = tcfg.get(arch).api(reduced=True)
        out[arch] = (japi, js.build_layout(japi, SERVE_SHAPE.seq_len, 4),
                     tapi, tlay(tapi))
    return out


def _route(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:
        return ("raised", str(e))


@pytest.mark.parametrize("mesh_name", list(SERVE_MESHES))
def test_serve_route_matches_jax(serve_layouts, mesh_name):
    """ROADMAP C.7: the port's ``resolve_serve_paged`` returns JAX's
    ``(route, why)`` or raises JAX's message for every arch id x paged
    off/auto/on on this mesh: FSDP archs take the gather route under
    "auto" and raise under "on"; a model axis > 1 takes the gather route
    under "auto", which "on" overrides; families without ``decode_paged``
    and the SSM's resident rows as in JAX."""
    shape = SERVE_MESHES[mesh_name]
    duck = None if shape is None else Duck(("data", "model"), shape)
    abstract = None if shape is None else trules.AbstractMesh(
        ("data", "model"), shape)
    seen = set()
    for arch in ARCHS:
        japi, jlay, tapi, tlayout = serve_layouts[arch]
        for paged in ("off", "auto", "on"):
            want = _route(jplan.resolve_serve_paged, japi, jlay,
                          jcfg.get(arch), duck, paged)
            got = _route(tplan.resolve_serve_paged, tapi, tlayout,
                         tcfg.get(arch), abstract, paged)
            assert got == want, (arch, paged)
            assert _route(tplan.resolve_serve_paged, tapi, tlayout, arch,
                          abstract, paged) == want, (arch, paged)
            seen.add(want[1] if want[0] != "raised" else "raised")
    assert "FSDP placement" in seen and "raised" in seen
    if shape is not None and shape[1] > 1:
        assert "model axis extent 2" in seen


@pytest.mark.parametrize("arch_id", ARCHS)
def test_long_context_decode_plan_matches_jax(arch_id):
    """ROADMAP C.1: ``long_500k`` builds the long-context config, as JAX's
    ``plan_decode`` does (qwen3-14b and zamba2-7b get the 8,192-row
    window)."""
    plan = tplan.plan_decode(arch_id, "long_500k")
    jp = jplan.plan_decode(arch_id, "long_500k", jmesh.make_host_mesh(1, 1),
                           reduced=True)
    assert plan.meta["long_ctx"] is jp.meta["long_ctx"] is True
    _, _, api = tplan._resolve(arch_id, "long_500k", False, None,
                               long_ctx=plan.meta["long_ctx"])
    _, _, japi_ = jplan._resolve(arch_id, "long_500k", False, None,
                                 long_ctx=True)

    def window(cfg):
        for c in (cfg, getattr(cfg, "attn_cfg", None),
                  getattr(cfg, "decoder_cfg", None)):
            if c is not None and hasattr(c, "swa_window"):
                return c.swa_window
        return None

    assert window(api.cfg) == window(japi_.cfg)
    if arch_id in ("qwen3-14b", "zamba2-7b"):
        assert window(api.cfg) == 8192


def test_engine_reexports_match_jax():
    """ROADMAP A.14's engine part: the plan names are public on both."""
    import repro.engine as je
    import repro_torch.engine as te
    for name in ("Plan", "make_train_engine", "plan_prefill", "plan_decode"):
        assert hasattr(je, name) and hasattr(te, name), name
    # build is public in the port's engine; the JAX package keeps it in
    # its plan module.
    assert te.build is tplan.build and callable(jplan.build)


# -- the grouped MoE ----------------------------------------------------------------

@pytest.mark.parametrize("extent", [2, 4])
@pytest.mark.parametrize("capacity_factor", [2.0, 0.5])
def test_grouped_moe_matches_jax(monkeypatch, extent, capacity_factor):
    """Tokens split into ``extent`` groups with per-group capacity; 0.5
    drops tokens. JAX's ambient mesh is faked (its constraints are the
    identity), the port's installed with ``use_mesh``."""
    api = jcfg.get("qwen2-moe-a2.7b").api(reduced=True)
    moe = dataclasses.replace(api.cfg.moe, capacity_factor=capacity_factor)
    d = api.cfg.d_model
    rng = np.random.default_rng(extent)
    e, f = moe.num_experts, moe.d_ff
    p = {"router": rng.standard_normal((d, e)).astype(np.float32),
         "w_gate": 0.1 * rng.standard_normal((e, d, f)).astype(np.float32),
         "w_up": 0.1 * rng.standard_normal((e, d, f)).astype(np.float32),
         "w_down": 0.1 * rng.standard_normal((e, f, d)).astype(np.float32)}
    if moe.shared_d_ff:
        fs = moe.shared_d_ff
        p["shared"] = {
            "w_gate": 0.1 * rng.standard_normal((d, fs)).astype(np.float32),
            "w_up": 0.1 * rng.standard_normal((d, fs)).astype(np.float32),
            "w_down": 0.1 * rng.standard_normal((fs, d)).astype(np.float32)}
    x = rng.standard_normal((4, 16, d)).astype(np.float32)
    fake = Duck(("data", "model"), (extent, 1))
    monkeypatch.setattr(jrules, "ambient_mesh", lambda: fake)
    monkeypatch.setattr(jrules, "ambient_constraint", lambda v, *a: v)
    jy, jaux = jmoe.moe_ffn(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                            moe, jnp.float32)
    with trules.use_mesh(trules.AbstractMesh(("data", "model"), (extent, 1))):
        assert tmoe.groups_for(64, moe) == extent
        ty, taux = tmoe.moe_ffn(params_from_jax(p, device="cpu"), torch.from_numpy(x), moe,
                                torch.float32)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    # The grouping moves the aux loss (one group is another number).
    ty1, taux1 = tmoe.moe_ffn(params_from_jax(p, device="cpu"), torch.from_numpy(x), moe,
                              torch.float32)
    assert float(taux1) != float(taux)
    # Decode-sized work keeps one group.
    with trules.use_mesh(trules.AbstractMesh(("data",), (extent,))):
        assert tmoe.groups_for(2, moe) == 1


def test_fsdp_is_read_from_the_registry():
    """Whether an arch takes the FSDP placement is its registry entry's
    ``fsdp`` flag: JAX's ``FSDP_ARCHS`` for every registered id, and for
    an entry registered under a new id (a depth cut) the same rules and
    placement verdict as the arch it copies, with no set to extend."""
    for arch_id in ARCHS:
        assert trules.is_fsdp(arch_id) == (arch_id in jrules.FSDP_ARCHS)
        assert trules.is_fsdp(tcfg.get(arch_id)) == trules.is_fsdp(arch_id)
    assert not trules.is_fsdp(None) and not trules.is_fsdp("no-such-arch")
    base = tcfg.get("deepseek-67b")
    cut_id = "deepseek-67b-test-cut"
    tcfg.REGISTRY[cut_id] = dataclasses.replace(base, arch_id=cut_id)
    try:
        before = set(trules.FSDP_ARCHS)
        assert trules.is_fsdp(cut_id)
        mesh = trules.AbstractMesh(("data", "model"), (2, 2))
        assert (trules.rules_for_arch(cut_id, SHAPES["train_4k"], mesh)
                == trules.rules_for_arch("deepseek-67b", SHAPES["train_4k"],
                                         mesh))
        assert tapi.kernel_placement_ok("on", cut_id) == (
            False, "FSDP placement")
        assert trules.FSDP_ARCHS == before
    finally:
        del tcfg.REGISTRY[cut_id]


@pytest.mark.parametrize("arch_id", ["deepseek-67b", "kimi-k2-1t-a32b"])
def test_init_keeps_blocks_as_drawn(arch_id):
    """Under ``layers.use_keep`` the initialiser hands each value to the
    hook as it is drawn: a stacked leaf one layer's slice at a time (a
    constant leaf only as a meta shape), and keeps what the hook returns.
    The kept params equal the whole init cut the same way, bit for bit."""
    from repro_torch import treemath as tm
    from repro_torch.models import layers as tlayers
    api = tcfg.get(arch_id).api(reduced=True)
    whole, axes = api.init(0, device="cpu")
    drawn = []

    def cut(x, ax):
        # Half of the first even "embed" dim, as a data extent of 2 keeps.
        lead = x.dim() - len(ax)
        for d, name in enumerate(ax):
            if name == "embed" and x.shape[lead + d] % 2 == 0:
                return x.narrow(lead + d, 0, x.shape[lead + d] // 2)
        return x

    def keep(x, ax):
        if x.device.type != "meta":
            drawn.append(tuple(x.shape))
        return cut(x, ax).clone()

    with tlayers.use_keep(keep):
        kept, kept_axes = api.init(0, device="cpu")
    assert kept_axes == axes
    stacked = {tuple(x.shape) for x in tm.tree_leaves(whole["layers"])}
    assert drawn and not set(drawn) & stacked
    for w, k, ax in zip(tm.tree_leaves(whole), tm.tree_leaves(kept),
                        trules.axes_leaves(axes)):
        assert torch.equal(k, cut(w, ax))
