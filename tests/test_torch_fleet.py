"""The port's mesh and fleet (``paddle_tpu_torch/distributed/mesh.py``,
``fleet/strategy.py``, ``fleet/topology.py``, ``fleet/__init__.py``)
against the JAX package on the CPU.

- ``ProcessMesh``'s shape API equals JAX's; the port's device list
  (default: the visible cards, raising for an id without one; an
  explicit list may repeat a device).
- ``hybrid_degrees`` fills dp from the device count as JAX's
  ``HybridCommunicateGroup`` does over its 8 virtual devices.
- ``HybridCommunicateGroup``'s axis order, mesh and query API; a degree
  above 1 on a non-sep axis (an auto-filled dp included) raises
  ``NotImplementedError`` naming its ROADMAP item.
- ``DistributedStrategy.hybrid_configs``: JAX's defaults and key order,
  merge on assign, loud errors; ``fleet.init`` and the namespace.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import paddle_tpu.distributed as jdist  # noqa: E402
from paddle_tpu.distributed.fleet import strategy as jstrategy  # noqa: E402
from paddle_tpu.distributed.fleet import topology as jtopology  # noqa: E402
from paddle_tpu_torch import distributed as tdist  # noqa: E402
from paddle_tpu_torch.distributed import fleet as tfleet  # noqa: E402
from paddle_tpu_torch.distributed.fleet import topology as ttopology  # noqa: E402,E501


@pytest.fixture
def fresh_fleet():
    yield
    tfleet._hcg = None
    tfleet._strategy = None


@pytest.mark.parametrize("grid,names", [
    (np.arange(4), ["sep"]), (np.arange(8).reshape(2, 4), ["dp", "sep"]),
    (np.arange(6).reshape(1, 3, 2), None)])
def test_process_mesh_api_equals_jax(grid, names):
    j = jdist.ProcessMesh(grid, names)
    t = tdist.ProcessMesh(grid, names, devices=["cpu"] * grid.size)
    for attr in ("shape", "ndim", "dim_names", "process_ids", "size"):
        assert getattr(t, attr) == getattr(j, attr), attr
    np.testing.assert_array_equal(t.mesh, j.mesh)
    for name in t.dim_names:
        assert t.get_dim_size(name) == j.get_dim_size(name)
    assert t.devices == [torch.device("cpu")] * grid.size


def test_process_mesh_devices():
    mesh = tdist.ProcessMesh(np.arange(4), ["sep"], devices=["cpu"] * 4)
    assert mesh.axis_devices("sep") == [torch.device("cpu")] * 4
    with pytest.raises(ValueError, match="one per id"):
        tdist.ProcessMesh(np.arange(4), ["sep"], devices=["cpu"] * 3)
    two = tdist.ProcessMesh(np.arange(4).reshape(2, 2), ["dp", "sep"],
                            devices=["cpu"] * 4)
    with pytest.raises(NotImplementedError, match="item 10"):
        two.axis_devices("sep")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n:
        assert tdist.ProcessMesh(np.arange(n), ["sep"]).devices == \
            [torch.device("cuda", i) for i in range(n)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdist.ProcessMesh(np.arange(n + 1), ["sep"])


@pytest.mark.parametrize("degrees", [
    {}, dict(sep_degree=2), dict(sep_degree=2, mp_degree=2),
    dict(dp_degree=2, sep_degree=2, mp_degree=2), dict(pp_degree=2,
                                                       sep_degree=4),
    dict(sep_degree=8), dict(dp_degree=3, sep_degree=4)])
def test_dp_fill_equals_jax(degrees):
    assert jax.device_count() == 8
    j = jtopology.HybridCommunicateGroup(**degrees)
    assert ttopology.hybrid_degrees(8, **degrees) == j.topology()


def test_degrees_that_do_not_divide_raise_like_jax():
    with pytest.raises(ValueError, match="divide"):
        jtopology.HybridCommunicateGroup(sep_degree=3)
    with pytest.raises(ValueError, match="divide"):
        ttopology.hybrid_degrees(8, sep_degree=3)


def test_hcg_sep_mesh_and_queries():
    hcg = tdist.fleet.HybridCommunicateGroup(sep_degree=4,
                                             devices=["cpu"] * 4)
    assert hcg.mesh.dim_names == ["dp", "pp", "sharding", "sep", "mp"]
    assert hcg.mesh.shape == [1, 1, 1, 4, 1]
    assert hcg.mesh.axis_devices("sep") == [torch.device("cpu")] * 4
    assert (hcg.get_sep_parallel_world_size(),
            hcg.get_data_parallel_world_size(),
            hcg.get_model_parallel_world_size(),
            hcg.get_pipe_parallel_world_size(),
            hcg.get_sharding_parallel_world_size()) == (4, 1, 1, 1, 1)
    assert hcg.get_parallel_mode() == "data_parallel"
    assert hcg.global_rank == 0
    one = tdist.fleet.HybridCommunicateGroup(devices=["cpu"])
    assert one.topology() == dict(dp=1, pp=1, sharding=1, sep=1, mp=1)


@pytest.mark.parametrize("degrees,n,item", [
    (dict(mp_degree=2), 2, "item 5"), (dict(sep_degree=2), 4, "item 10"),
    (dict(pp_degree=2, sep_degree=2), 4, "item 10"),
    (dict(sharding_degree=2), 2, "item 10")])
def test_non_sep_axis_raises(degrees, n, item):
    with pytest.raises(NotImplementedError, match=item):
        tdist.fleet.HybridCommunicateGroup(devices=["cpu"] * n, **degrees)


def test_hcg_default_devices_are_the_cards():
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        if n > 1:      # dp fills to n, which is not placed yet
            with pytest.raises(NotImplementedError, match="item 10"):
                tdist.fleet.HybridCommunicateGroup()
        else:
            hcg = tdist.fleet.HybridCommunicateGroup()
            assert hcg.mesh.devices == [torch.device("cuda", 0)]
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdist.fleet.HybridCommunicateGroup(sep_degree=1)


def test_strategy_hybrid_configs_like_jax():
    j, t = jstrategy.DistributedStrategy(), tfleet.DistributedStrategy()
    assert t.hybrid_configs == j.hybrid_configs
    assert list(t.hybrid_configs) == list(j.hybrid_configs)
    j.hybrid_configs = {"sep_degree": 4}
    t.hybrid_configs = {"sep_degree": 4}
    t.hybrid_configs = {"dp_degree": 1}
    j.hybrid_configs = {"dp_degree": 1}
    assert t.hybrid_configs == j.hybrid_configs
    assert t.hybrid_configs["sep_degree"] == 4
    with pytest.raises(ValueError, match="unknown hybrid_configs"):
        t.hybrid_configs = {"sep_degre": 2}
    with pytest.raises(NotImplementedError, match="item 9"):
        t.recompute = True
    with pytest.raises(NotImplementedError, match="item 10"):
        t.amp = True
    with pytest.raises(AttributeError, match="no knob"):
        t.hybrid_config = {}


def test_fleet_init_builds_the_group(fresh_fleet):
    assert tfleet.get_hybrid_communicate_group() is None
    strategy = tfleet.DistributedStrategy()
    strategy.hybrid_configs = {"sep_degree": 2}
    hcg = tdist.fleet.fleet.init(is_collective=True, strategy=strategy,
                                 devices=["cpu", "cpu"])
    assert tfleet.get_hybrid_communicate_group() is hcg
    assert tfleet.fleet.get_hybrid_communicate_group() is hcg
    assert hcg.get_sep_parallel_world_size() == 2
    with pytest.raises(NotImplementedError, match="item 10"):
        tfleet.distributed_model(torch.nn.Linear(2, 2))
    with pytest.raises(NotImplementedError, match="item 10"):
        tfleet.fleet.distributed_optimizer(None)
