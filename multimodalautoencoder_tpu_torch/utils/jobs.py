"""Sequential batch-job runner (reference: run_jobs.py).

A copy of ``multimodalautoencoder_tpu/utils/jobs.py`` (it imports nothing
of JAX; the port keeps its own copy so that it never imports the JAX
package).

Job file format (run_jobs.py:5-21): 4 lines per job —
name / shell command / output file path / blank line.

Kept contracts: refusal to clobber an existing output file (:123-129),
the "suspiciously fast job" warning below MINIMUM_JOB_SECONDS (:37,
:154-157), the last-N-lines digest (:38, :163-168), and a final summary.
Notification goes through a pluggable callback (default: logging) — the
reference's Gmail SMTP with hard-coded credentials (:33-36, :60-83) is
replaced; pass ``notify=smtp_notifier(...)`` to restore email delivery.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import time
from typing import Callable, List, Optional

MINIMUM_JOB_SECONDS = 600     # run_jobs.py:37
PRINT_LAST_X_LINES = 300      # run_jobs.py:38
SUCCESS, ERROR, WARNING = 0, 1, 2


@dataclasses.dataclass
class Job:
    name: str
    command: str
    output_file: str


@dataclasses.dataclass
class JobResult:
    job: Job
    status: int
    seconds: float
    message: str


def load_job_file(path: str) -> List[Job]:
    """Parse the 4-line-per-job format (run_jobs.py:85-106: name,
    command, output path, blank separator).

    Divergence from the reference's blind ``i += 4`` stride: the
    separator line must actually be blank.  A misaligned file under the
    stride parser silently shifts fields — job NAMES become shell
    COMMANDS — so a non-blank separator is a loud error here."""
    jobs: List[Job] = []
    with open(path) as f:
        lines = [l.rstrip("\n") for l in f]
    i = 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        if i + 2 >= len(lines):
            break
        jobs.append(Job(name=lines[i].strip(), command=lines[i + 1].strip(),
                        output_file=lines[i + 2].strip()))
        i += 3
        if i < len(lines) and lines[i].strip():
            raise ValueError(
                f"{path}:{i + 1}: expected a blank separator line after "
                f"job {jobs[-1].name!r}, got {lines[i]!r} — each job is "
                "name / command / output-path / blank line")
    return jobs


def log_notifier(subject: str, text: str) -> None:
    print(f"[job-runner] {subject}\n{text}")


def smtp_notifier(sending_address: str, password: str,
                  to_addrs: List[str], host: str = "smtp.gmail.com",
                  port: int = 587) -> Callable[[str, str], None]:
    """Reference-style Gmail SMTP notification (run_jobs.py:60-83), as an
    opt-in factory instead of hard-coded module constants."""
    def notify(subject: str, text: str) -> None:
        import smtplib

        body = "\r\n".join([f"From: {sending_address}",
                            f"To: {', '.join(to_addrs)}",
                            f"Subject: {subject}", "", text])
        server = smtplib.SMTP(host, port)
        try:
            server.ehlo()
            server.starttls()
            server.login(sending_address, password)
            server.sendmail(sending_address, to_addrs, body)
        finally:
            server.quit()
    return notify


def run_job(job: Job, notify: Callable[[str, str], None] = log_notifier,
            minimum_seconds: float = MINIMUM_JOB_SECONDS,
            digest_lines: int = PRINT_LAST_X_LINES) -> JobResult:
    """Run one job, capturing stdout+stderr to its output file
    (run_jobs.py:108-170)."""
    if os.path.exists(job.output_file):
        msg = (f"Output file {job.output_file} already exists; refusing "
               f"to overwrite — job skipped")
        notify(f"Job {job.name}: SKIPPED", msg)
        return JobResult(job, ERROR, 0.0, msg)

    t0 = time.time()
    proc = subprocess.run(job.command, shell=True,
                          stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    seconds = time.time() - t0

    out_dir = os.path.dirname(job.output_file)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    with open(job.output_file, "w") as f:
        f.write(proc.stdout or "")

    tail = "\n".join((proc.stdout or "").splitlines()[-digest_lines:])
    status = SUCCESS if proc.returncode == 0 else ERROR
    msg = f"finished in {seconds:.0f}s (exit {proc.returncode})"
    if status == SUCCESS and seconds < minimum_seconds:
        status = WARNING
        msg += (f"; WARNING: took under {minimum_seconds:.0f}s — "
                f"suspiciously fast, check the output")
    label = {SUCCESS: "SUCCESS", ERROR: "ERROR",
             WARNING: "WARNING"}[status]
    notify(f"Job {job.name}: {label}", msg + "\n\n" + tail)
    return JobResult(job, status, seconds, msg)


def run_jobs(path: str,
             notify: Callable[[str, str], None] = log_notifier,
             minimum_seconds: float = MINIMUM_JOB_SECONDS
             ) -> List[JobResult]:
    """Run every job in a job file sequentially, then send a summary
    (run_jobs.py:191-199)."""
    jobs = load_job_file(path)
    results = [run_job(j, notify, minimum_seconds) for j in jobs]
    summary = "\n".join(f"{r.job.name}: "
                        f"{['SUCCESS', 'ERROR', 'WARNING'][r.status]} "
                        f"({r.seconds:.0f}s)" for r in results)
    notify("ALL JOBS FINISHED", summary)
    return results


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="Run a 4-line-per-job batch file sequentially")
    ap.add_argument("job_file")
    ap.add_argument("--min-seconds", type=float,
                    default=MINIMUM_JOB_SECONDS)
    args = ap.parse_args(argv)
    run_jobs(args.job_file, minimum_seconds=args.min_seconds)


if __name__ == "__main__":
    main()
