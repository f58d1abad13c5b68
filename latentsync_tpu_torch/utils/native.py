"""The host paste-back library ``native/restore.cpp``, through the JAX
package's ctypes binding ``latentsync_tpu.utils.native``.

That binding runs ``make -C native`` at first use and returns None when
the build fails. ``restore_lib()`` builds the library first and raises if
it cannot: when the compiler named by ``$CXX`` fails (a toolchain without
OpenMP's ``libgomp``, as on some GPU hosts), it retries with the ``g++``
on ``PATH``. The port has no other paste-back path.
"""

from __future__ import annotations

import os
import subprocess
import threading

_lock = threading.Lock()


def restore_lib():
    """The ``latentsync_tpu.utils.native`` module, its library built."""
    from latentsync_tpu.utils import native

    with _lock:
        if not os.path.isfile(native._LIB_PATH):
            errors = []
            for extra in ([], ["CXX=g++"]):
                proc = subprocess.run(["make", "-C", native._NATIVE_DIR, *extra],
                                      capture_output=True, text=True)
                if proc.returncode == 0:
                    break
                errors.append(proc.stdout[-1000:] + proc.stderr[-2000:])
            else:
                raise RuntimeError("native/restore.cpp did not build:\n" + "\n".join(errors))
        if native.get_lib() is None:
            raise RuntimeError(f"cannot load {native._LIB_PATH}")
    return native
