"""Stdout tee Logger + run banners (reference flair_hub/utils/messaging.py)."""

from __future__ import annotations

import datetime
import logging
import os
import sys

from flair_for_aigle_tpu_torch.parallel.dist import rank_zero_only

logger = logging.getLogger(__name__)

BANNER = r"""
  _____ _        _    ___ ____       _   _ _   _ ____      _____ ____  _   _
 |  ___| |      / \  |_ _|  _ \     | | | | | | | __ )    |_   _|  _ \| | | |
 | |_  | |     / _ \  | || |_) _____| |_| | | | |  _ \ _____| | | |_) | | | |
 |  _| | |___ / ___ \ | ||  _ |_____|  _  | |_| | |_) |_____| | |  __/| |_| |
 |_|   |_____/_/   \_|___|_| \_\    |_| |_|\___/|____/      |_| |_|    \___/
_____________________________________________________________________________
"""


@rank_zero_only
def start_msg():
    logger.info(BANNER)
    logger.info("#" * 55)
    logger.info("#################### LAUNCHING ########################")
    logger.info(datetime.datetime.now().strftime("Starting: %Y-%m-%d  %H:%M"))
    logger.info("[ ] Setting up Logger     . . .")
    logger.info("[ ] Creating output files . . .")
    logger.info("[ ] Reading config files  . . .")
    logger.info("[ ] Building up datasets  . . .")


@rank_zero_only
def end_msg():
    logger.info("#" * 55)
    logger.info("####################  FINISHED  #######################")
    logger.info(datetime.datetime.now().strftime("Ending: %Y-%m-%d  %H:%M"))


class Logger:
    """Mirror stdout to the terminal and a uniquely-named log file
    (reference messaging.py:182-254)."""

    def __init__(self, filename: str = "Default.log") -> None:
        filename = self._get_unique_filename(filename)
        self.terminal = sys.stdout
        self.log = open(filename, "w", encoding="utf-8")
        self.encoding = getattr(self.terminal, "encoding", "utf-8")

    def _get_unique_filename(self, filename: str) -> str:
        base, ext = os.path.splitext(filename)
        if not os.path.exists(filename):
            return filename
        version = 1
        while True:
            candidate = f"{base}_v{version}{ext}"
            if not os.path.exists(candidate):
                return candidate
            version += 1

    def write(self, message: str) -> None:
        self.terminal.write(message)
        self.log.write(message)

    def flush(self) -> None:
        self.log.flush()

    def close(self) -> None:
        self.log.close()

    def isatty(self) -> bool:
        return False
