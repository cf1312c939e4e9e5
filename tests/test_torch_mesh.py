"""The port's mesh (rvdd_tpu_torch/parallel/mesh.py) against rvdd_tpu's
(rvdd_tpu/parallel/mesh.py) on the conftest's 8 virtual CPU devices.

* ``make_mesh``: for each spec, process count and batch size of the table,
  the port's ``data`` and ``space`` sizes are rvdd_tpu's over as many
  devices (rank = d * M + s, rvdd_tpu's ``reshape(n, s)``); where rvdd_tpu
  raises, the port raises the same exception.  One known difference
  (ROADMAP.md Queue 3): a mesh of other than the process count raises
  ``ValueError`` (rvdd_tpu leaves the other devices idle).
* ``shard_batch``: each rank's rows equal the addressable shard rvdd_tpu's
  ``shard_batch`` puts on the device of the same index, bit for bit; under
  a space axis a rank's data rows are rvdd_tpu's, and its rows of each
  patch are its blocks of the aligned cut (rvdd_tpu cuts evenly).
* ``init_distributed`` raises without torchrun's environment, and for CUDA
  without a card; it never falls back to one CPU process.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from rvdd_tpu.parallel import mesh as jmesh  # noqa: E402
from rvdd_tpu_torch.parallel import mesh  # noqa: E402

SPECS = ("data", "data1", "data2", "data4", "data3", "data2xspace2", "bad", "data1xspace2",
         "dataxspace2", "data2xspace4", "data1xspace4")


def _rvdd_tpu(spec, n, batch):
    """(data, space) of rvdd_tpu's mesh over n devices, or the exception
    type it raises."""
    try:
        m = jmesh.make_mesh(spec, devices=jax.devices()[:n], batch_size=batch)
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return type(e)
    return dict(m.shape)["data"], dict(m.shape)["space"]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("n,batch", [(1, None), (2, 2), (4, 4), (4, 2), (4, 3), (8, 6)])
def test_make_mesh_matches_rvdd_tpu(spec, n, batch):
    want = _rvdd_tpu(spec, n, batch)
    if isinstance(want, type):
        with pytest.raises(want):
            mesh.make_mesh(spec, world_size=n, batch_size=batch)
        return
    data, space = want
    if data * space != n:
        with pytest.raises(ValueError, match=f"data axis of {data} .*for a batch of {batch} "
                                             f"over {n} processes"):
            mesh.make_mesh(spec, world_size=n, batch_size=batch)
    else:
        m = mesh.make_mesh(spec, world_size=n, batch_size=batch)
        assert (m.data, m.space, m.rank, m.world_size, m.group) == (data, space, 0, n, None)
        jm = jmesh.make_mesh(spec, devices=jax.devices()[:n], batch_size=batch)
        for r, device in enumerate(jm.devices.flat):  # rank = d * M + s
            d, s = map(int, np.argwhere(jm.devices == device)[0])
            mr = dataclasses.replace(m, rank=r)
            assert (mr.data_index, mr.space_index) == (d, s)


def test_the_table_reaches_every_outcome():
    """The table above holds meshes the port builds, with and without a
    space axis, and each of the ways it refuses."""
    outcomes = set()
    for spec in SPECS:
        for n, batch in ((1, None), (4, 4), (4, 3)):
            try:
                m = mesh.make_mesh(spec, world_size=n, batch_size=batch)
                outcomes.add("built" + ("(space)" if m.space > 1 else ""))
            except ValueError as e:
                outcomes.add("ValueError" + ("(bad)" if "bad" in str(e) else ""))
    assert outcomes == {"built", "built(space)", "ValueError", "ValueError(bad)"}


def test_shard_batch_matches_rvdd_tpu_shards():
    rng = np.random.default_rng(0)
    batch = {"frames": rng.standard_normal((8, 3, 4, 5, 4)).astype(np.float32),
             "flows": rng.standard_normal((8, 2, 1, 4, 5, 2)).astype(np.float32),
             "gt": rng.standard_normal((8, 3, 8, 10, 3)).astype(np.float32)}
    jm = jmesh.make_mesh("data4", devices=jax.devices()[:4])
    sharded = jmesh.shard_batch(jm, batch)
    m = mesh.make_mesh("data4", world_size=4)
    for r, device in enumerate(jm.devices.flat):
        got = mesh.shard_batch(dataclasses.replace(m, rank=r), batch)
        tgot = mesh.shard_batch(dataclasses.replace(m, rank=r),
                                {k: torch.from_numpy(v) for k, v in batch.items()})
        for k, arr in sharded.items():
            (want,) = [s.data for s in arr.addressable_shards if s.device == device]
            np.testing.assert_array_equal(got[k], np.asarray(want))
            np.testing.assert_array_equal(tgot[k].numpy(), np.asarray(want))
    assert mesh.shard_batch(m, {"flows": None})["flows"] is None
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard_batch(m, batch["gt"][:6])


def test_shard_batch_cuts_space_rows_in_aligned_blocks():
    """data2xspace2 over 4 ranks: a rank's data rows are rvdd_tpu's data
    shard's; its rows of the raw patch (axis -3, 20 rows) are its whole
    blocks of 8, the ragged tail on the last shard, and of the RGB ground
    truth twice those; the shards tile every tensor."""
    rng = np.random.default_rng(1)
    batch = {"n": rng.standard_normal((4, 3, 20, 6, 4)).astype(np.float32),
             "flow": rng.standard_normal((4, 2, 1, 20, 6, 2)).astype(np.float32),
             "gt": rng.standard_normal((4, 3, 40, 12, 3)).astype(np.float32)}
    jm = jmesh.make_mesh("data2", devices=jax.devices()[:2])
    jdata = jmesh.shard_batch(jm, batch["n"])
    m = mesh.make_mesh("data2xspace2", world_size=4, row_align=8)
    got = {k: np.zeros_like(v) for k, v in batch.items()}
    for r in range(4):
        mr = dataclasses.replace(m, rank=r)
        sh = mesh.shard_batch(mr, batch, spatial_axis=-3)
        d, s = mr.data_index, mr.space_index
        rows = [(0, 8), (8, 20)][s]
        assert sh["n"].shape[-3] == rows[1] - rows[0]
        (want,) = [x.data for x in jdata.addressable_shards if x.device == jm.devices.flat[d]]
        np.testing.assert_array_equal(sh["n"], np.asarray(want)[..., rows[0]:rows[1], :, :])
        got["n"][2 * d:2 * d + 2, ..., rows[0]:rows[1], :, :] = sh["n"]
        got["flow"][2 * d:2 * d + 2, ..., rows[0]:rows[1], :, :] = sh["flow"]
        got["gt"][2 * d:2 * d + 2, ..., 2 * rows[0]:2 * rows[1], :, :] = sh["gt"]
    for k, v in got.items():
        np.testing.assert_array_equal(v, batch[k], err_msg=k)
    with pytest.raises(ValueError, match="whole block"):
        mesh.shard_batch(m, {"n": batch["n"][..., :15, :, :]}, spatial_axis=-3)


def test_replicate_without_a_group():
    net = torch.nn.Conv2d(2, 3, 3)
    before = [p.detach().clone() for p in net.parameters()]
    mesh.replicate(mesh.make_mesh("data"), net)
    assert all(torch.equal(a, b) for a, b in zip(before, net.parameters()))
    with pytest.raises(RuntimeError, match="without a process group"):
        mesh.replicate(mesh.make_mesh("data4", world_size=4), net)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_init_distributed_refuses_to_fall_back(device, monkeypatch):
    for k in mesh.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun's environment"):
        mesh.init_distributed(device)
    if device == "cuda" and not torch.cuda.is_available():
        for k, v in zip(mesh.TORCHRUN_ENV, ("0", "1", "0", "127.0.0.1", "1")):
            monkeypatch.setenv(k, v)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.init_distributed(device)
    assert not torch.distributed.is_initialized()
