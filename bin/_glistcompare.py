#!/usr/bin/env -S python3 -S -u
# Fast launcher: CPython -S skips site initialization (.pth files and
# customization hooks), which keeps start-up short; the interpreter's
# site-packages are added by hand below. The package imports jax
# lazily (utils/lazyjax.py) only when a pipeline picks the device.
import os
import sys

# the virtual environment this interpreter runs in (-S leaves sys.prefix
# at the base installation, so find it from the executable's location)
_venv = os.environ.get("VIRTUAL_ENV") or os.path.dirname(
    os.path.dirname(os.path.abspath(sys.executable)))
_sp = os.path.join(_venv, "lib",
                   "python%d.%d" % sys.version_info[:2], "site-packages")
if os.path.isfile(os.path.join(_venv, "pyvenv.cfg")) and os.path.isdir(_sp):
    sys.path.insert(0, _sp)
else:                      # not a venv: fall back to full site init
    import site
    site.main()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from genometester4_tpu.cli.glistcompare import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
