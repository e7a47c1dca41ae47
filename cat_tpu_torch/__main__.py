"""``python -m cat_tpu_torch <verb> <flags>``: the port's verbs, with the
flags of the JAX package's ``train.py``, ``distill.py``, ``profile.py``,
``export.py``, ``get_real_stat.py`` and ``tools/kid_score.py``.  They run on
CUDA.  ``train`` and ``distill`` also run data-parallel: ``--n_devices k``
spawns k ranks, one card each; ``--num_processes``, ``--process_id`` and
``--coordinator_address`` (or a launcher's environment with ``--multihost
1``, e.g. ``torchrun -m cat_tpu_torch distill ... --multihost 1``) join
processes started one per card (``parallel/multihost.py``)."""

from __future__ import annotations

import sys

_VERBS = ("train", "distill", "profile", "export", "get_real_stat", "kid_score")


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in _VERBS:
        sys.exit(f"usage: python -m cat_tpu_torch {{{','.join(_VERBS)}}} [flags]")
    from cat_tpu_torch import entry

    verb = {"train": entry.train_main, "distill": entry.distill_main, "profile": entry.profile_main,
            "export": entry.export_main, "get_real_stat": entry.real_stat_main,
            "kid_score": entry.kid_score_main}
    verb[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
