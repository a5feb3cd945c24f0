"""Port parity, the model zoo's configurations: every ``ArchConfig`` of
``repro_torch.configs.REGISTRY`` equals the reference's field for field,
full and ``.reduced()``, and the shape cells and their applicability rule
are the reference's."""
import dataclasses

import pytest

from repro.configs import REGISTRY as JREGISTRY
from repro.configs import get_arch as jget_arch
from repro.models import config as jconfig
from repro_torch.configs import REGISTRY, get_arch
from repro_torch.models import config as tconfig

ARCHS = sorted(JREGISTRY)


def test_registry_has_the_reference_ids_in_its_order():
    assert list(REGISTRY) == list(JREGISTRY)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", ARCHS)
def test_arch_config_fields_equal(name, reduced):
    want, got = JREGISTRY[name], get_arch(name)
    if reduced:
        want, got = want.reduced(), got.reduced()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.hd, got.q_groups) == (want.hd, want.q_groups)
    assert got.validate() is got


def test_shape_cells_and_applicability_equal():
    assert [dataclasses.asdict(c) for c in tconfig.SHAPES] == [
        dataclasses.asdict(c) for c in jconfig.SHAPES]
    for name in ARCHS:
        for tcell, jcell in zip(tconfig.SHAPES, jconfig.SHAPES):
            assert (tconfig.shape_applicable(REGISTRY[name], tcell)
                    == jconfig.shape_applicable(JREGISTRY[name], jcell))


def test_unknown_arch_raises_like_the_reference():
    with pytest.raises(KeyError) as want:
        jget_arch("gpt-5")
    with pytest.raises(KeyError) as got:
        get_arch("gpt-5")
    assert str(got.value) == str(want.value)
