"""``python -m cat_tpu_torch distill <flags>``: the port's distill verb, with
the flags of the JAX package's ``distill.py``.  It runs on CUDA."""

from __future__ import annotations

import sys

_VERBS = ("distill",)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in _VERBS:
        sys.exit(f"usage: python -m cat_tpu_torch {{{','.join(_VERBS)}}} [flags]")
    from cat_tpu_torch import entry

    entry.distill_main(argv[1:])


if __name__ == "__main__":
    main()
