"""The port's nearest-codebook search (igm_tpu_torch.ops.vq) against
igm_tpu's: the XLA branch of ``igm_tpu.ops.vq.nearest_codebook`` (taken on
the CPU, where ``pallas_vq.supported`` is false) and the Pallas kernel
``nearest_codebook_pallas`` in interpret mode.

Inputs are made with numpy from a seed.  Tolerance: the indices are equal,
except that a row may differ at a near-tie, where the two summation orders
of the float32 products meet: the plain version's scores at the two indices
then differ by at most 1e-5 (||e||^2 + 2 ||z|| ||e||)
(``near_tie_gaps`` <= 1).  Each test reports how many rows differ.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from igm_tpu.ops import vq as jvq  # noqa: E402
from igm_tpu.ops.pallas_vq import nearest_codebook_pallas  # noqa: E402
from igm_tpu_torch.ops.vq import (  # noqa: E402
    near_tie_gaps, nearest_codebook, nearest_codebook_plain, quantize)

torch.set_num_threads(1)


def _normal(m, k, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, d)).astype(np.float32),
            rng.normal(size=(k, d)).astype(np.float32))


def _ties(m, k, d, seed):
    """Every code of the first half appears again, shuffled, in the second:
    each row's best score is an exact tie between two indices."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(k // 2, d)).astype(np.float32)
    book = np.concatenate([base, base[rng.permutation(k // 2)]])
    return rng.normal(size=(m, d)).astype(np.float32), book


def _on_codes(m, k, d, seed):
    """z rows that are codebook rows."""
    rng = np.random.default_rng(seed)
    book = rng.normal(size=(k, d)).astype(np.float32)
    return book[rng.integers(0, k, m)], book


CASES = {"normal": (_normal, 512, 128, 64), "ties": (_ties, 256, 64, 16),
         "z_on_codes": (_on_codes, 256, 128, 32), "latent_shape": (_normal, 512, 512, 64)}


def _case(name):
    make, m, k, d = CASES[name]
    return make(m, k, d, seed=len(name))


def _check(z, book, got, want):
    n_diff, gap, _ = near_tie_gaps(torch.from_numpy(z), torch.from_numpy(book),
                                torch.from_numpy(np.array(got)),
                                torch.from_numpy(np.array(want)))
    print(f"rows that differ: {n_diff} of {len(z)}, largest gap {gap:.3g}")
    assert gap <= 1.0, f"{n_diff} rows differ, largest gap {gap} is no near-tie"
    return n_diff


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_xla_branch(name):
    z, book = _case(name)
    want = np.asarray(jvq.nearest_codebook(jnp.asarray(z), jnp.asarray(book)))
    got = nearest_codebook(torch.from_numpy(z), torch.from_numpy(book))
    assert got.dtype == torch.int32 and got.shape == (len(z),)
    n_diff = _check(z, book, got.numpy(), want)
    if name != "normal" and name != "latent_shape":
        assert n_diff == 0              # exact ties and exact hits do not flip


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_pallas_interpret(name):
    z, book = _case(name)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(nearest_codebook_pallas(jnp.asarray(z), jnp.asarray(book),
                                                  tile_m=128))
    got = nearest_codebook_plain(torch.from_numpy(z), torch.from_numpy(book))
    n_diff = _check(z, book, got.numpy(), want)
    if name != "normal" and name != "latent_shape":
        assert n_diff == 0


def test_exact_ties_go_to_the_lower_index():
    z, book = _case("ties")
    got = nearest_codebook(torch.from_numpy(z), torch.from_numpy(book)).numpy()
    for i in got:
        # the lowest index holding the chosen code
        assert i == np.flatnonzero((book == book[i]).all(axis=1))[0]


def test_z_on_codes_finds_them():
    rng = np.random.default_rng(3)
    book = rng.normal(size=(128, 32)).astype(np.float32)
    pick = rng.integers(0, 128, 256)
    got = nearest_codebook(torch.from_numpy(book[pick]), torch.from_numpy(book))
    np.testing.assert_array_equal(got.numpy(), pick)


def test_quantize_gathers_and_keeps_the_codebook_gradient():
    z, book = _case("normal")
    want_q, want_i = jvq.quantize(jnp.asarray(z), jnp.asarray(book))
    tbook = torch.from_numpy(book).requires_grad_()
    tz = torch.from_numpy(z).requires_grad_()
    quant, idx = quantize(tz, tbook)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(quant.detach().numpy(), np.asarray(want_q))
    quant.sum().backward()
    assert tz.grad is None                            # the search has no gradient
    counts = np.bincount(idx.numpy(), minlength=len(book)).astype(np.float32)
    np.testing.assert_array_equal(tbook.grad.numpy(),
                                  np.repeat(counts[:, None], book.shape[1], 1))


def test_cpu_takes_the_plain_version_and_counts_no_launch():
    z, book = _case("z_on_codes")
    before = nearest_codebook.launches
    got = nearest_codebook(torch.from_numpy(z), torch.from_numpy(book))
    assert nearest_codebook.launches == before
    torch.testing.assert_close(got, nearest_codebook_plain(torch.from_numpy(z),
                                                           torch.from_numpy(book)))
    with pytest.raises(ValueError):
        nearest_codebook(torch.zeros(4, 8), torch.zeros(16, 4))
