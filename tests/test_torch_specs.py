"""``repro_torch.models.specs`` vs ``repro.models.specs``: for every
architecture (published config) and every shape cell, the same inputs with
the same shapes, element types and logical axes — the training batch, the
prefill batch (``image_embeds`` of a vlm, ``frames`` of an encdec) and the
decode cache and tokens.  The port's descriptors are ``ShapeDtype``
``(shape, torch dtype)`` pairs, the reference's ``jax.ShapeDtypeStruct``.
"""
import pytest

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.models import specs as ref_specs

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.models import common, specs
from repro_torch.trees import tree_leaves


def _flat(tree):
    """``{path: (shape, dtype name)}`` of a tree of descriptors."""
    if isinstance(tree, dict):
        return {f"{k}/{p}": v for k in tree for p, v in _flat(tree[k]).items()}
    return {"": (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("cell", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_the_reference(arch, cell):
    """(descriptors, axes) pairs: one for a training or prefill batch,
    two (the cache, the tokens) for decode."""
    ref = ref_specs.input_specs(ref_get_config(arch), REF_SHAPES[cell])
    got = specs.input_specs(get_config(arch), SHAPES[cell])
    assert len(got) == len(ref) == (4 if SHAPES[cell].kind == "decode"
                                    else 2)
    for i, (want_part, got_part) in enumerate(zip(ref, got)):
        if i % 2:
            assert got_part == want_part                 # logical axes
        else:
            assert _flat(got_part) == _flat(want_part)
            assert all(isinstance(leaf, common.ShapeDtype)
                       for _, leaf in tree_leaves(got_part))
    extra = {"vlm": "image_embeds", "encdec": "frames"}.get(
        get_config(arch).family)
    if SHAPES[cell].kind != "decode":
        assert sorted(got[0]) == sorted(
            ["tokens", "positions"] + [extra] * (extra is not None)
            + ["targets", "loss_mask", "segment_ids"]
            * (SHAPES[cell].kind == "train"))


def test_unknown_cell_kind_raises():
    cell = SHAPES["train_4k"].__class__("x", 8, 1, "serve")
    with pytest.raises(ValueError):
        specs.input_specs(get_config("qwen2-0.5b"), cell)
