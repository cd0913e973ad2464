"""The port's MapReduce data plane against the JAX package's, on the CPU: the
same jobs make the same blocks, and every workload's result is element-equal
(integers, exact) to ``repro.mapreduce.run_mapreduce``'s, whatever the chunk
of blocks the map takes at a time."""
import numpy as np
import pytest
import torch

from repro.mapreduce import MRJob as JaxMRJob
from repro.mapreduce import run_mapreduce as jax_run_mapreduce
from repro.mapreduce.engine import VOCAB as JAX_VOCAB
from repro.mapreduce.engine import WORKLOAD_FNS as JAX_WORKLOAD_FNS
from repro.mapreduce.engine import make_blocks as jax_make_blocks
from repro_torch.mapreduce import VOCAB, WORKLOAD_FNS, MRJob, make_blocks, run_mapreduce
from repro_torch.mapreduce.engine import MAP_BYTES_PER_TOKEN, chunk_blocks

WORKLOADS = ["wordcount", "grep", "sort", "permutation", "inverted_index"]


def test_workloads_and_blocks_are_the_reference_s():
    assert VOCAB == JAX_VOCAB
    assert list(WORKLOAD_FNS) == list(JAX_WORKLOAD_FNS) == WORKLOADS
    for seed in (0, 3):
        job = MRJob("wordcount", n_blocks=3, block_tokens=100, n_reducers=4, seed=seed)
        jjob = JaxMRJob("wordcount", n_blocks=3, block_tokens=100, n_reducers=4, seed=seed)
        blocks = make_blocks(job)
        assert blocks.dtype == np.int32 and blocks.shape == (3, 100)
        np.testing.assert_array_equal(blocks, jax_make_blocks(jjob))


@pytest.mark.parametrize("n_reducers", [1, 4, 8])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_run_mapreduce_equals_the_reference(workload, n_reducers):
    kw = dict(n_blocks=6, block_tokens=512, n_reducers=n_reducers, seed=1)
    ref = np.asarray(jax_run_mapreduce(JaxMRJob(workload, **kw)))
    out = run_mapreduce(MRJob(workload, **kw), device="cpu")
    assert out.dtype == torch.int32 and tuple(out.shape) == ref.shape
    np.testing.assert_array_equal(out.numpy(), ref)
    # the same blocks handed in, as numpy and as a tensor
    blocks = make_blocks(MRJob(workload, **kw))
    for given in (blocks, torch.from_numpy(blocks)):
        np.testing.assert_array_equal(
            run_mapreduce(MRJob(workload, **kw), given, device="cpu").numpy(), ref)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_results_do_not_depend_on_the_chunk(workload):
    """One block a map call, three, and all six at once give equal results."""
    job = MRJob(workload, n_blocks=6, block_tokens=512, n_reducers=8, seed=2)
    per_block = MAP_BYTES_PER_TOKEN * job.block_tokens
    assert [chunk_blocks(job.block_tokens, b) for b in (1, 3 * per_block, 6 * per_block)] \
        == [1, 3, 6]
    outs = [run_mapreduce(job, device="cpu", budget_bytes=b)
            for b in (1, 3 * per_block, 6 * per_block)]
    for out in outs[1:]:
        assert torch.equal(out, outs[0])


def test_permutation_rolls_within_each_block():
    """The roll wraps within a block (the reference vmaps it per block), not
    across the batch: a block's first keys pair with its own last tokens."""
    blocks = np.array([[1, 2, 3, 4], [100, 200, 300, 400]], dtype=np.int32)
    job = MRJob("permutation", n_blocks=2, block_tokens=4, n_reducers=1)
    out = run_mapreduce(job, blocks, device="cpu").numpy().reshape(-1)
    keys = np.concatenate([(b * 31 + np.roll(b, s)) % VOCAB
                           for b in blocks for s in range(4)])
    np.testing.assert_array_equal(out, np.bincount(keys, minlength=VOCAB))
    np.testing.assert_array_equal(
        out, np.asarray(jax_run_mapreduce(JaxMRJob("permutation", 2, 4, 1), blocks))[0])


def test_reducers_that_do_not_divide_the_vocab_raise():
    with pytest.raises(ValueError, match="n_reducers 3 does not divide VOCAB 4096"):
        run_mapreduce(MRJob("wordcount", n_blocks=2, block_tokens=16, n_reducers=3),
                      device="cpu")


def test_run_mapreduce_defaults_to_the_card():
    """The default device is the card; with none, it raises rather than
    running on the CPU unasked."""
    job = MRJob("grep", n_blocks=2, block_tokens=64, n_reducers=2)
    if torch.cuda.is_available():
        out = run_mapreduce(job)
        assert out.device.type == "cuda"
        assert torch.equal(out.cpu(), run_mapreduce(job, device="cpu"))
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_mapreduce(job)
