"""`python -m skeres.cli` — list the available command-line tools."""

print(__import__("skeres.cli", fromlist=["__doc__"]).__doc__)
