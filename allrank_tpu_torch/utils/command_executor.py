"""Shell command wrapper (the JAX package's ``utils/command_executor.py``).

Kept for user scripts; the package's own IO uses shutil. Runs through
subprocess and raises on a non-zero exit.
"""

from __future__ import annotations

import subprocess

from allrank_tpu_torch.utils.ltr_logging import get_logger

logger = get_logger()


def execute_command(command: str) -> None:
    logger.info("will execute %s", command)
    result = subprocess.run(command, shell=True)
    if result.returncode != 0:
        raise RuntimeError(
            f"command exited with a non-zero code: {command} "
            f"(exit code {result.returncode})"
        )
