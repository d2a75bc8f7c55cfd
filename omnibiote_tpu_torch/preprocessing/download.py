"""GenBank corpus mirror over anonymous FTP.

    python -m omnibiote_tpu_torch.preprocessing.download --dest_dir raw/

The port's copy of `omnibiote_tpu/preprocessing/download.py`, itself the
behavioural equivalent of the reference downloader
(preprocessing/download_genbank.py:5-61 of the reference): fetch every
*.seq.gz under ftp.ncbi.nih.gov/genbank, skip files whose local size already
matches the remote, and survive dropped connections with bounded
retry + reconnect. Partial local files are re-fetched from byte zero (FTP
REST resume is deliberately not used, matching the reference).

Re-expressed for this repo: connection lifecycle lives in _Session
(reconnect-on-error), the per-file mirror decision is its own function, and
the FTP client class is injectable so the zero-egress test suite can run an
offline double.
"""
from __future__ import annotations

import ftplib
import os
import time
from typing import Callable, List, Optional

_TRANSIENT = (ftplib.error_temp, EOFError, IOError)


class _Session:
    """One logged-in FTP session pinned to a remote directory."""

    def __init__(self, make_client: Callable, address: str, directory: str):
        self._make = make_client
        self._address = address
        self._directory = directory
        self._ftp = None
        self.reconnect()

    def reconnect(self):
        self._ftp = self._make(self._address)
        self._ftp.login()
        self._ftp.cwd(self._directory)

    def listing(self, suffix: str) -> List[str]:
        return [n for n in self._ftp.nlst() if n.endswith(suffix)]

    def remote_size(self, name: str) -> int:
        self._ftp.voidcmd("TYPE I")  # sizes are only meaningful in binary
        return self._ftp.size(name)

    def fetch(self, name: str, local: str):
        with open(local, "wb") as f:
            self._ftp.retrbinary("RETR " + name, f.write)


def _mirror_one(sess: _Session, name: str, dest_dir: str, log) -> bool:
    """Fetch one remote file unless the local copy is already complete.
    Returns True iff bytes were transferred."""
    local = os.path.join(dest_dir, name)
    if os.path.exists(local):
        if os.path.getsize(local) == sess.remote_size(name):
            log(f"skip {name}: local copy already complete")
            return False
        log(f"size mismatch for {name}: refetching from byte 0")
    sess.fetch(name, local)
    return True


def download_seq_files(
    ftp_address: str,
    directory: str,
    file_format: str,
    dest_dir: str = ".",
    max_retries: int = 5,
    retry_delay: float = 5.0,
    ftp_factory: Optional[Callable] = None,
    log=print,
) -> List[str]:
    """Mirror every `file_format` file under `directory`; returns the names
    that were actually transferred this run."""
    make_client = ftp_factory or (lambda addr: ftplib.FTP(addr))
    os.makedirs(dest_dir, exist_ok=True)
    sess = _Session(make_client, ftp_address, directory)

    transferred: List[str] = []
    for name in sess.listing(file_format):
        for attempt in range(1, max_retries + 1):
            try:
                if _mirror_one(sess, name, dest_dir, log):
                    transferred.append(name)
                break
            except _TRANSIENT as e:
                log(f"transient failure on {name} "
                    f"(attempt {attempt}/{max_retries}): {e}; "
                    f"retrying in {retry_delay}s")
                time.sleep(retry_delay)
                try:
                    sess.reconnect()
                except _TRANSIENT as e2:
                    # the server being unreachable during reconnection is
                    # the LIKELY state after a transient drop — it must
                    # consume this attempt, not abort the whole mirror run
                    log(f"reconnect failed (attempt {attempt}/"
                        f"{max_retries}): {e2}")
        else:
            log(f"giving up on {name} after {max_retries} attempts")
    return transferred


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="Mirror GenBank .seq.gz via FTP")
    ap.add_argument("--ftp_address", default="ftp.ncbi.nih.gov")
    ap.add_argument("--directory", default="/genbank")
    ap.add_argument("--file_format", default=".seq.gz")
    ap.add_argument("--dest_dir", default=".")
    a = ap.parse_args()
    download_seq_files(a.ftp_address, a.directory, a.file_format, a.dest_dir)
