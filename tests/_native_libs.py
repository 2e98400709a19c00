"""Loading a native host library for a parity test.

Both packages build their C++ host runtime on first use. The reference's
build (``bullet_tpu/native``) writes one fixed temporary name beside its
library, so when several test processes build it at once, all but one can
fail, and a loser's ``_load_failed`` flag then holds for the rest of that
process, although the library now exists. A parity test that compares the
two packages' native paths loads each library through ``load_native``,
which retries such a load once, so that it compares native against native
whichever process built the library."""

import os


def load_native(native, monkeypatch):
    """``native.load()`` of either package's ``native`` module; where that
    gave None with the failure flag set while the library file exists (a
    lost build race, not a missing toolchain or BULLET_NO_NATIVE), the flag
    is cleared for this test and the load tried once more. Returns the
    library or None."""
    lib = native.load()
    path = native._lib_path() if hasattr(native, "_lib_path") else native._LIB
    if (lib is None and native._load_failed and not os.environ.get("BULLET_NO_NATIVE")
            and os.path.exists(path)):
        monkeypatch.setattr(native, "_load_failed", False)
        lib = native.load()
    return lib
