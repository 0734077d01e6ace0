"""Job submission — drivers as managed subprocesses.

Reference surface: ray job submit / JobSubmissionClient
(ray: python/ray/dashboard/modules/job/ — REST to the dashboard, a
JobManager spawning the driver process, status + log streaming). Here
the manager is local: each job is a driver subprocess with its own
framework session, logs captured to the job dir, status tracked by
process lifecycle — the same lifecycle verbs (submit/status/logs/stop)
without the HTTP hop.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import uuid
from typing import Dict, List, Optional


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"


class _Job:
    __slots__ = ("job_id", "entrypoint", "proc", "log_path", "status",
                 "start_time", "end_time", "metadata")

    def __init__(self, job_id, entrypoint, log_path, metadata):
        self.job_id = job_id
        self.entrypoint = entrypoint
        self.proc: Optional[subprocess.Popen] = None
        self.log_path = log_path
        self.status = JobStatus.PENDING
        self.start_time = time.time()
        self.end_time: Optional[float] = None
        self.metadata = metadata or {}


class JobSubmissionClient:
    """submit_job/get_job_status/get_job_logs/stop_job/list_jobs."""

    def __init__(self, jobs_dir: Optional[str] = None):
        # job driver output belongs in the session log dir when a
        # runtime is up: `job-<id>.out` sits next to the worker capture
        # files, so list_logs / the CLI / the dashboard see it too
        from ray_tpu_torch._private import log_plane
        self._dir = (jobs_dir or log_plane.get_session_log_dir()
                     or tempfile.mkdtemp(prefix="ray_tpu_torch_jobs_"))
        self._jobs: Dict[str, _Job] = {}
        self._lock = threading.Lock()

    def submit_job(self, *, entrypoint: str,
                   submission_id: Optional[str] = None,
                   working_dir: Optional[str] = None,
                   env_vars: Optional[Dict[str, str]] = None,
                   metadata: Optional[Dict[str, str]] = None) -> str:
        job_id = submission_id or f"raytpu-job-{uuid.uuid4().hex[:10]}"
        log_path = os.path.join(self._dir, f"{job_id}.out")
        job = _Job(job_id, entrypoint, log_path, metadata)
        # job drivers talk to the cluster over ray:// — the head owns
        # the card, so a job's driver sees none (CUDA_VISIBLE_DEVICES="":
        # no CUDA context of its own, hundreds of MB of the card saved)
        # and reaches the card through the head's tasks. A job that
        # really wants the card names the devices in env_vars: a
        # non-empty CUDA_VISIBLE_DEVICES there is the opt-in, and
        # env_vars is applied last, so it wins.
        from ray_tpu_torch._private import spawn_env
        wants_accel = bool((env_vars or {}).get(
            "CUDA_VISIBLE_DEVICES", "").strip())
        env = spawn_env.child_env(
            use_accelerator=wants_accel,
            extra=dict({"RAY_TPU_TORCH_JOB_ID": job_id},
                       **(env_vars or {})))
        log_f = open(log_path, "wb")
        job.proc = subprocess.Popen(
            entrypoint, shell=True, cwd=working_dir or os.getcwd(),
            stdout=log_f, stderr=subprocess.STDOUT, env=env,
            start_new_session=True)
        job.status = JobStatus.RUNNING
        with self._lock:
            self._jobs[job_id] = job
        threading.Thread(target=self._monitor, args=(job, log_f),
                         daemon=True,
                         name=f"ray_tpu_job_{job_id}").start()
        return job_id

    def _monitor(self, job: _Job, log_f) -> None:
        rc = job.proc.wait()
        log_f.close()
        job.end_time = time.time()
        if job.status != JobStatus.STOPPED:
            job.status = (JobStatus.SUCCEEDED if rc == 0
                          else JobStatus.FAILED)

    def get_job_status(self, job_id: str) -> str:
        return self._job(job_id).status

    def get_job_logs(self, job_id: str) -> str:
        job = self._job(job_id)
        try:
            with open(job.log_path, "rb") as f:
                return f.read().decode(errors="replace")
        except FileNotFoundError:
            return ""

    def stop_job(self, job_id: str) -> bool:
        job = self._job(job_id)
        if job.proc is None or job.proc.poll() is not None:
            return False
        job.status = JobStatus.STOPPED
        try:
            os.killpg(os.getpgid(job.proc.pid), signal.SIGTERM)
        except ProcessLookupError:
            pass
        return True

    def list_jobs(self) -> List[Dict]:
        with self._lock:
            jobs = list(self._jobs.values())
        return [
            {"submission_id": j.job_id, "entrypoint": j.entrypoint,
             "status": j.status, "start_time": j.start_time,
             "end_time": j.end_time, "metadata": dict(j.metadata)}
            for j in jobs
        ]

    def wait_until_finish(self, job_id: str,
                          timeout: float = 120.0) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            st = self.get_job_status(job_id)
            if st in (JobStatus.SUCCEEDED, JobStatus.FAILED,
                      JobStatus.STOPPED):
                return st
            time.sleep(0.1)
        return self.get_job_status(job_id)

    def _job(self, job_id: str) -> _Job:
        with self._lock:
            job = self._jobs.get(job_id)
        if job is None:
            raise ValueError(f"unknown job {job_id!r}")
        return job


def _default_client() -> JobSubmissionClient:
    global _client
    try:
        return _client
    except NameError:
        _client = JobSubmissionClient()
        return _client
