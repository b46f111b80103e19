"""Process groups and the coordinated checkpoint of the port
(``medfusion_tpu_torch/parallel/multihost.py``, ``utils/checkpoint.py``)
with two real processes on gloo: the counterpart of
``tests/test_multihost.py``.

Both ranks initialise over a ``tcp://`` address (a second call is a no-op),
take their slice of the batch, all-reduce, build the mesh, train an
FSDP-sharded model two steps with EMA, and both call ``save_checkpoint``:
rank 0 writes the whole state, and restoring gives each rank its own pieces
again, the parameters, the EMA copy and Adam's moments bit for bit.
"""

import numpy as np
import pytest
import torch

from medfusion_tpu_torch.parallel.multihost import initialize_multihost, per_host_batch_slice
from tests import torch_parallel_worker as W


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multihost")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 8)).astype(np.float32))
    wait = W.spawn("multihost", 2, tmp)
    W.write_inputs(tmp, {"x": x})
    yield W.load_results(tmp, "multihost", 2, wait)


def test_two_ranks_initialise_once(ranks):
    for rank, r in enumerate(ranks):
        assert r["info"] == {"process_index": rank, "process_count": 2,
                             "local_device_count": 1, "global_device_count": 2}
        assert r["again"] == r["info"]  # the second call is a no-op
        assert r["backend"] == "gloo"  # the CPU device's backend
        assert r["mesh"] == (2, 1)


def test_per_host_batch_slice_and_an_all_reduce(ranks):
    for rank, r in enumerate(ranks):
        assert r["slice"] == (4 * rank, 4 * rank + 4)
        assert r["total"] == 28.0  # sum(range(8)) over both ranks' rows


def test_per_host_batch_slice_without_a_group():
    assert per_host_batch_slice(8) == slice(0, 8)


def test_coordinated_checkpoint_holds_the_whole_state(ranks):
    for r in ranks:
        assert r["latest"] == 7
        assert r["sharded"] == ["0.bias", "0.weight", "1.weight"]  # >= 16 elements
        assert r["saved_shapes"]["0.weight"] == (16, 8)
        assert r["saved_shapes"]["1.weight"] == (8, 16)
        assert r["local_shapes"]["0.weight"] != r["saved_shapes"]["0.weight"]
        assert r["saved_whole"] and r["pieces"]
        assert r["params_dict"] == ["0.bias", "0.weight", "1.bias", "1.weight"]


def test_coordinated_restore_gives_each_rank_its_pieces(ranks):
    for r in ranks:
        assert r["step"] == 2
        assert r["restored"] and r["restored_ema"] and r["restored_moments"]


def test_initialise_refuses_an_unknown_device():
    with pytest.raises(ValueError, match="no process-group backend"):
        initialize_multihost(device="meta")
