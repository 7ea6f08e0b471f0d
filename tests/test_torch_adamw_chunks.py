"""``optim.adamw.apply`` updates a leaf of more than ``adamw.CHUNK``
elements a slice of its leading axis at a time: the same elementwise
arithmetic, so the same bits as updating it whole, on every leaf shape
(stacked, two-dimensional, a vector), in float32 and bfloat16."""
from unittest import mock

import pytest
import torch

from repro_torch.optim import adamw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [1, 7, 100, 1 << 20])
def test_chunked_update_is_bit_equal_to_the_whole(dtype, chunk):
    g = torch.Generator().manual_seed(0)

    def tree():
        return {"layers": {"w": torch.randn(5, 6, 7, generator=g),
                           "b": torch.randn(5, 7, generator=g)},
                "embed": torch.randn(33, 4, generator=g),
                "scale": torch.randn(9, generator=g),
                "lone": torch.randn((), generator=g)}

    params = adamw.tree_map(lambda t: t.to(dtype), tree())
    grads = adamw.tree_map(lambda t: t.to(dtype), tree())
    state = adamw.init(params)
    state = state._replace(m=tree(), v=adamw.tree_map(torch.abs, tree()))
    whole = adamw.apply(params, grads, state)
    with mock.patch.object(adamw, "CHUNK", chunk):
        got = adamw.apply(params, grads, state)
    pairs = list(zip(adamw.leaves(got[0]), adamw.leaves(whole[0]))) + [
        (a, b) for x, y in ((got[1].m, whole[1].m), (got[1].v, whole[1].v))
        for a, b in zip(adamw.leaves(x), adamw.leaves(y))]
    for a, b in pairs:
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(got[2], whole[2])
