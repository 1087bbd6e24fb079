"""``python -m graph_slam_tpu_torch <command>``: the port's command line
(``cli.main``)."""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
