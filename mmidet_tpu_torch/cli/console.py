"""The ``mmidet-torch-*`` console scripts (``pyproject.toml``).

Each calls its entry point's ``main()`` with no arguments, so that it
reads ``sys.argv``, on the card.  A console script exits with what its
function returns, and these ``main``s return their results (an
``EvalResults``, a path, the service): handed to ``sys.exit`` such an
object is printed and exits 1, so each script returns 0 after its
``main`` instead."""

from __future__ import annotations


def train() -> int:
    from mmidet_tpu_torch.cli.train import main
    main()
    return 0


def val() -> int:
    from mmidet_tpu_torch.cli.val import main
    main()
    return 0


def detect() -> int:
    from mmidet_tpu_torch.cli.detect import main
    main()
    return 0


def export() -> int:
    from mmidet_tpu_torch.deploy.export import main
    main()
    return 0


def serve() -> int:
    from mmidet_tpu_torch.deploy.serve import main
    main()
    return 0
