"""Repository-wide pytest settings.

* Registers the ``cuda`` marker: a test that needs an NVIDIA GPU carries
  it and skips (from inside the test, never at import) where
  ``torch.cuda.is_available()`` is false.
* Ignores ``repro.kernels.layout_decode.HostFallbackWarning`` outside the
  tests that check it.  pytest-xdist rebuilds each warning a worker
  reports as ``cls(message)``, and that class's ``__init__`` takes a
  tuple of ``(name, width)`` pairs, so an uncaptured one takes the worker
  down.  The tests that assert the warning set their own filters
  (``pytest.warns`` / ``warnings.simplefilter``), which take precedence.
"""
import importlib.util


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where there is none")
    if importlib.util.find_spec("jax") is not None \
            and importlib.util.find_spec("repro") is not None:
        config.addinivalue_line(
            "filterwarnings",
            "ignore::repro.kernels.layout_decode.HostFallbackWarning")
