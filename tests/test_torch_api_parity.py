"""Symbol-level API parity of the port with the reference surface.

Every public symbol of ``tests/test_api_parity.py:REFERENCE_SURFACE``
exists under the same name in the same module of the port, but for an
explicit list of what is not ported yet, each entry tagged with its
ROADMAP item; the list is checked both ways, so a symbol that lands must
leave it.  The package's ``__all__`` carries the reference's exports."""

import importlib

import pytest
from test_api_parity import REFERENCE_ALL, REFERENCE_SURFACE

# module -> symbols the port does not have yet, and the ROADMAP item that ports them
UNPORTED = {
    "cli": ("A14", REFERENCE_SURFACE["cli"]),
}
UNPORTED_MODULES = {"cli"}


@pytest.mark.parametrize("module", sorted(REFERENCE_SURFACE))
def test_module_symbols_present(module):
    if module in UNPORTED_MODULES:
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(f"fenicsx_beat_tpu_torch.{module}")
        return
    mod = importlib.import_module(f"fenicsx_beat_tpu_torch.{module}")
    missing = [n for n in REFERENCE_SURFACE[module] if not hasattr(mod, n)]
    assert missing == list(UNPORTED.get(module, ("", []))[1]), (
        f"fenicsx_beat_tpu_torch.{module} lacks {missing}; the unported list says "
        f"{UNPORTED.get(module, ('', []))}"
    )


def test_package_all_superset():
    import fenicsx_beat_tpu_torch as beat

    missing = [n for n in REFERENCE_ALL if n not in beat.__all__ or not hasattr(beat, n)]
    assert not missing, f"__all__ lacks reference exports: {missing}"
