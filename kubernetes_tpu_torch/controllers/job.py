"""Job + CronJob controllers.

The counterpart of `kubernetes_tpu/controllers/job.py`: the same behaviour,
names and store writes, held equal to it by the port's tests.

reference: pkg/controller/job/job_controller.go (syncJob: pod counting,
parallelism/completions, backoffLimit -> Failed condition) and
pkg/controller/cronjob/cronjob_controllerv2.go (syncCronJob: unmet schedule
times, concurrencyPolicy, history limits).
"""

from __future__ import annotations

from typing import List, Optional

from ..api import Pod
from ..api.workloads import CronJob, Job, JobSpec, PodTemplateSpec
from ..store import AlreadyExistsError, NotFoundError
from ..utils.cron import CronSchedule
from .base import Controller

JOB_NAME_LABEL = "job-name"
COMPLETION_INDEX_ANNOTATION = "batch.kubernetes.io/job-completion-index"


def pod_completion_index(pod: Pod) -> int:
    try:
        return int(pod.metadata.annotations.get(COMPLETION_INDEX_ANNOTATION, -1))
    except (TypeError, ValueError):  # null/garbage annotation: no index
        return -1


def compress_indexes(indexes) -> str:
    """{0,1,2,5} -> "0-2,5" (batch/v1 completedIndexes wire form)."""
    out = []
    run_start = prev = None
    for i in sorted(indexes):
        if prev is None:
            run_start = prev = i
            continue
        if i == prev + 1:
            prev = i
            continue
        out.append(str(run_start) if run_start == prev
                   else f"{run_start}-{prev}")
        run_start = prev = i
    if prev is not None:
        out.append(str(run_start) if run_start == prev
                   else f"{run_start}-{prev}")
    return ",".join(out)


def job_owner_ref(job: Job) -> dict:
    return {"apiVersion": "batch/v1", "kind": "Job", "name": job.metadata.name,
            "uid": job.metadata.uid, "controller": True}


def _owned_by_job(pod: Pod, job: Job) -> bool:
    return any(r.get("kind") == "Job" and r.get("uid") == job.metadata.uid
               for r in pod.metadata.owner_references)


class JobController(Controller):
    watch_kinds = ("jobs", "pods")

    def key_of_object(self, kind: str, obj) -> Optional[str]:
        if kind == "jobs":
            return obj.key
        for ref in obj.metadata.owner_references:
            if ref.get("kind") == "Job":
                return f"{obj.metadata.namespace}/{ref['name']}"
        return None

    def sync(self, key: str) -> None:
        try:
            job: Job = self.store.get("jobs", key)
        except NotFoundError:
            self._delete_owned_pods(key)
            return
        pods, _ = self.store.list(
            "pods", lambda p: p.metadata.namespace == job.metadata.namespace
            and _owned_by_job(p, job))
        active = [p for p in pods if not p.is_terminal()
                  and p.metadata.deletion_timestamp is None]
        succeeded = sum(1 for p in pods if p.status.phase == "Succeeded")
        failed = sum(1 for p in pods if p.status.phase == "Failed")
        # nil completions = work-queue job (job_controller.go manageJob):
        # wantActive is parallelism, and the job completes when any pod
        # succeeds and no pods remain active (JobSpec's documented semantic).
        completions = job.spec.completions
        indexed = job.spec.completion_mode == "Indexed" and completions is not None
        completed_idx = set()
        if indexed:
            # per-index completion (indexed_job_utils.go): an index counts
            # once, however many retried pods succeeded for it
            completed_idx = {pod_completion_index(p) for p in pods
                             if p.status.phase == "Succeeded"}
            completed_idx = {i for i in completed_idx
                             if 0 <= i < completions}
            succeeded = len(completed_idx)

        condition = None
        want_active = len(active)
        if job.is_finished():
            pass  # terminal; pods are left for TTL/GC (job_controller.go)
        elif job.spec.completion_mode == "Indexed" and completions is None:
            # admission rejects this on the REST path; a direct store write
            # must fail loudly, not silently run as a work-queue job whose
            # pods carry no index identity
            condition = {"type": "Failed", "status": "True",
                         "reason": "InvalidSpec",
                         "message": "completions is required for Indexed jobs"}
            for p in active:
                self._try_delete_pod(p)
            want_active = 0
        elif failed > job.spec.backoff_limit:
            condition = {"type": "Failed", "status": "True", "reason": "BackoffLimitExceeded"}
            for p in active:
                self._try_delete_pod(p)
            want_active = 0
        elif (succeeded >= completions if completions is not None
              else succeeded >= 1 and not active):
            condition = {"type": "Complete", "status": "True"}
        elif job.spec.suspend:
            for p in active:
                self._try_delete_pod(p)
            want_active = 0
        elif indexed:
            # create pods for MISSING indexes: not completed, no active pod
            # holding the index (failed pods free their index for a retry)
            active_idx = {pod_completion_index(p) for p in active}
            missing = [i for i in range(completions)
                       if i not in completed_idx and i not in active_idx]
            want_active = min(job.spec.parallelism, completions - succeeded)
            for i in missing[:max(0, want_active - len(active))]:
                self._create_pod(job, index=i)
            if want_active < len(active):
                # scale-down: drop highest indexes first (reference prefers
                # keeping the lowest ones for stable completion)
                for p in sorted(active, key=pod_completion_index,
                                reverse=True)[: len(active) - want_active]:
                    self._try_delete_pod(p)
        else:
            # wantActive (job_controller.go manageJob): bounded by parallelism
            # and by the completions still owed; scales down as well as up
            if completions is None:
                # work-queue semantics: full parallelism until the first
                # success, then just let running pods drain — but always
                # capped by parallelism so lowering it scales down
                want_active = job.spec.parallelism if succeeded == 0 \
                    else min(len(active), job.spec.parallelism)
            else:
                want_active = min(job.spec.parallelism, completions - succeeded)
            for _ in range(max(0, want_active - len(active))):
                self._create_pod(job)
            for p in active[want_active:] if want_active < len(active) else []:
                self._try_delete_pod(p)

        def mutate(obj: Job) -> Job:
            obj.status.active = want_active
            obj.status.succeeded = succeeded
            obj.status.failed = failed
            if indexed:
                obj.status.completed_indexes = compress_indexes(completed_idx)
            if obj.status.start_time is None and not job.spec.suspend:
                obj.status.start_time = self.clock.now()
            if condition is not None and not obj.status.conditions:
                # both terminal conditions carry a transition time — the TTL
                # controller counts ttlSecondsAfterFinished from it
                condition["lastTransitionTime"] = self.clock.now()
                obj.status.conditions = [condition]
                if condition["type"] == "Complete":
                    obj.status.completion_time = self.clock.now()
            return obj

        try:
            self.store.guaranteed_update("jobs", key, mutate)
        except NotFoundError:
            pass

    def _create_pod(self, job: Job, index: Optional[int] = None) -> None:
        import uuid

        template = job.spec.template
        if index is not None:
            name = f"{job.metadata.name}-{index}-{uuid.uuid4().hex[:5]}"
        else:
            name = f"{job.metadata.name}-{uuid.uuid4().hex[:5]}"
        pod = template.make_pod(name, job.metadata.namespace, job_owner_ref(job))
        pod.metadata.labels[JOB_NAME_LABEL] = job.metadata.name
        if index is not None:
            # the index rides an annotation + label and the canonical env var
            # (job_controller.go podGenerator for Indexed mode) — a TPU
            # training pod reads JOB_COMPLETION_INDEX to pick its data shard
            pod.metadata.annotations[COMPLETION_INDEX_ANNOTATION] = str(index)
            pod.metadata.labels[COMPLETION_INDEX_ANNOTATION] = str(index)
            for c in pod.spec.containers:
                c.env = list(c.env) + [{"name": "JOB_COMPLETION_INDEX",
                                        "value": str(index)}]
        if pod.spec.restart_policy == "Always":
            # job pods may not be Always (batch/validation); default to Never
            pod.spec.restart_policy = "Never"
        try:
            self.store.create("pods", pod)
        except AlreadyExistsError:
            pass

    def _try_delete_pod(self, pod: Pod) -> None:
        try:
            self.store.delete("pods", pod.key)
        except NotFoundError:
            pass

    def _delete_owned_pods(self, key: str) -> None:
        ns, name = key.split("/", 1)
        pods, _ = self.store.list(
            "pods", lambda p: p.metadata.namespace == ns and any(
                r.get("kind") == "Job" and r.get("name") == name
                for r in p.metadata.owner_references))
        for p in pods:
            self._try_delete_pod(p)


def cronjob_owner_ref(cj: CronJob) -> dict:
    return {"apiVersion": "batch/v1", "kind": "CronJob", "name": cj.metadata.name,
            "uid": cj.metadata.uid, "controller": True}


def _owned_by_cronjob(job: Job, cj: CronJob) -> bool:
    return any(r.get("kind") == "CronJob" and r.get("uid") == cj.metadata.uid
               for r in job.metadata.owner_references)


class CronJobController(Controller):
    """Time-based Job creation. Time comes from the injected clock, so tests
    step a FakeClock through schedule boundaries (cronjob_controllerv2.go
    now()-injection)."""

    watch_kinds = ("cronjobs", "jobs")

    def key_of_object(self, kind: str, obj) -> Optional[str]:
        if kind == "cronjobs":
            return obj.key
        for ref in obj.metadata.owner_references:
            if ref.get("kind") == "CronJob":
                return f"{obj.metadata.namespace}/{ref['name']}"
        return None

    def resync_due(self) -> None:
        """Mark every CronJob dirty (the reference requeues at next schedule
        time; the daemon loop calls this each tick)."""
        cjs, _ = self.store.list("cronjobs")
        for cj in cjs:
            self._mark(cj.key)

    def sync(self, key: str) -> None:
        try:
            cj: CronJob = self.store.get("cronjobs", key)
        except NotFoundError:
            return
        jobs, _ = self.store.list(
            "jobs", lambda j: j.metadata.namespace == cj.metadata.namespace
            and _owned_by_cronjob(j, cj))
        active = [j for j in jobs if not j.is_finished()]
        self._prune_history(cj, jobs)
        if cj.spec.suspend:
            return
        now = self.clock.now()
        try:
            schedule = CronSchedule(cj.spec.schedule, tz=cj.spec.time_zone)
        except ValueError:
            # admission rejects these on the REST path; a direct store write
            # with a bad schedule/timeZone must not hot-spin the controller
            # (the reference records UnknownTimeZone and skips the object)
            return
        # earliestTime: lastScheduleTime, else creationTimestamp (getRecentUnmet
        # ScheduleTimes); an object with no creation stamp starts counting now.
        since = cj.status.last_schedule_time
        if since is None:
            since = cj.metadata.creation_timestamp or now
        due = schedule.times_between(since, now)
        if not due:
            return
        scheduled_time = due[-1]
        if (cj.spec.starting_deadline_seconds is not None
                and now - scheduled_time > cj.spec.starting_deadline_seconds):
            return  # missed the window (syncCronJob tooLate)
        if active:
            if cj.spec.concurrency_policy == "Forbid":
                return
            if cj.spec.concurrency_policy == "Replace":
                for j in active:
                    self._delete_job(j)
        self._create_job(cj, scheduled_time)

        def mutate(obj: CronJob) -> CronJob:
            obj.status.last_schedule_time = scheduled_time
            return obj

        try:
            self.store.guaranteed_update("cronjobs", key, mutate)
        except NotFoundError:
            pass

    def _create_job(self, cj: CronJob, scheduled_time: float) -> None:
        import copy

        # deterministic name from the minute stamp (getJobName)
        name = f"{cj.metadata.name}-{int(scheduled_time) // 60}"
        spec: JobSpec = copy.deepcopy(cj.spec.job_template)
        job = Job(spec=spec)
        job.metadata.name = name
        job.metadata.namespace = cj.metadata.namespace
        job.metadata.owner_references = [cronjob_owner_ref(cj)]
        from ..api.types import new_uid

        job.metadata.uid = new_uid()
        job.metadata.creation_timestamp = self.clock.now()
        try:
            self.store.create("jobs", job)
        except AlreadyExistsError:
            pass  # already created for this schedule time

    def _delete_job(self, job: Job) -> None:
        # cascade: the JobController's NotFound path deletes the pods
        try:
            self.store.delete("jobs", job.key)
        except NotFoundError:
            pass

    def _prune_history(self, cj: CronJob, jobs: List[Job]) -> None:
        finished = [j for j in jobs if j.is_finished()]
        ok = sorted((j for j in finished if any(
            c.get("type") == "Complete" and c.get("status") == "True"
            for c in j.status.conditions)), key=lambda j: j.metadata.creation_timestamp)
        bad = sorted((j for j in finished if any(
            c.get("type") == "Failed" and c.get("status") == "True"
            for c in j.status.conditions)), key=lambda j: j.metadata.creation_timestamp)
        for j in ok[:max(0, len(ok) - cj.spec.successful_jobs_history_limit)]:
            self._delete_job(j)
        for j in bad[:max(0, len(bad) - cj.spec.failed_jobs_history_limit)]:
            self._delete_job(j)
