"""Root test configuration: build the JAX package's native JSON libraries
once, before any test process starts.

``openpystruct_tpu/datagen/native.py`` compiles ``native/dataset_writer.cpp``
and ``native/dataset_reader.cpp`` on first use, with g++ writing straight
into the final ``native/build/*.so`` path.  Under ``pytest -n N`` every
worker imports the native-IO test modules at collection, so on a tree
without ``native/build`` the workers compile into the same file at once; a
worker that loads a half-written library marks the toolchain as missing and
its native tests skip.  Building here, in the controlling process, leaves
the libraries in place before the workers are spawned, and each worker
then only loads them.

The module is loaded by file path, so the ``.so`` names and compiler flags
stay the JAX package's own and no JAX import happens before
``tests/conftest.py`` configures JAX.  Without g++ the build fails quietly
and the same tests skip as before.
"""

import importlib.util
from pathlib import Path

_NATIVE = Path(__file__).resolve().parent / "openpystruct_tpu" / "datagen" / "native.py"


def pytest_configure(config):
    if hasattr(config, "workerinput") or not _NATIVE.is_file():
        return   # an xdist worker: the controller has built the libraries
    spec = importlib.util.spec_from_file_location("_native_prebuild", _NATIVE)
    native = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(native)
    native._build_and_load()
    native._build_and_load_reader()
