#!/usr/bin/env python
"""Shim: the bundle adjuster CLI lives in the installed package.

    python -m skeres.cli.bundle_adjuster [flags]
"""

from skeres.cli.bundle_adjuster import main

if __name__ == "__main__":
    main()
