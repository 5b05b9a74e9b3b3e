"""Replicator orchestration: where pipelines actually run.

Reference parity: the `K8sClient` trait (crates/etl-api/src/k8s/base.rs:197)
with its HTTP implementation (k8s/http.rs, 3.2k LoC) creating per-pipeline
StatefulSets/Secrets/ConfigMaps — and, crucially, the trait seam that makes
multi-node fully testable without a cluster (SURVEY §4.7).

Implementations:
  - K8sOrchestrator: talks to the Kubernetes API over HTTP (fake server in
    tests) creating the same resource triple per pipeline;
  - LocalOrchestrator: runs replicator subprocesses on this host — the
    single-node deployment and the demo path.

Copy of the reference's `etl_tpu/api/orchestrator.py`. The manifests are
the reference's byte for byte apart from the package a container runs
(`etl_tpu_torch.maintenance`, the port's copy of the reference's
maintenance module); the local children run
`python -m etl_tpu_torch.replicator`, which decodes on the card unless
the config document says `batch: {device: cpu}`.
"""

from __future__ import annotations

import abc
import asyncio
import json
import signal
import sys
from dataclasses import dataclass
from pathlib import Path

import aiohttp
import yaml

from ..models.errors import ErrorKind, EtlError


@dataclass(frozen=True)
class ReplicatorSpec:
    pipeline_id: int
    tenant_id: str
    config: dict  # full replicator config document (plaintext)
    image: "str | None" = None  # container image override (images CRUD)
    # horizontal scale-out (docs/sharding.md): shard_count > 1 splits the
    # publication across K replica sets — the orchestrator creates ONE
    # StatefulSet per shard, each pod told its slice via `shard` /
    # `shard_count` config keys. `shard` set on a spec pins it to one
    # shard (the per-shard spec the fan-out derives); shard_count 0 =
    # derive from the config document's own shard_count key.
    shard: "int | None" = None
    shard_count: int = 0

    def effective_shard_count(self) -> int:
        if self.shard_count:
            return self.shard_count
        try:
            return max(1, int(self.config.get("shard_count", 1) or 1))
        except (TypeError, ValueError):
            return 1


@dataclass
class ReplicatorStatus:
    pipeline_id: int
    state: str  # "stopped" | "starting" | "running" | "failed"
    detail: str = ""
    # degraded reasons from the pod's live /health probe (supervision
    # health state machine) — a pipeline can be `running` yet degraded;
    # the /fleet endpoint aggregates these across the whole fleet
    reasons: tuple = ()


class Orchestrator(abc.ABC):
    @abc.abstractmethod
    async def start_pipeline(self, spec: ReplicatorSpec) -> None: ...

    @abc.abstractmethod
    async def stop_pipeline(self, pipeline_id: int) -> None: ...

    @abc.abstractmethod
    async def status(self, pipeline_id: int) -> ReplicatorStatus: ...

    async def list_pipelines(self) -> "dict[int, int]":
        """Enumerate every pipeline this orchestrator runs:
        pipeline_id → live shard count. The fleet reconciler's observe
        step and the chaos leak checks both depend on it; orchestrators
        that cannot enumerate cannot join a fleet."""
        raise EtlError(
            ErrorKind.CONFIG_INVALID,
            f"{type(self).__name__} cannot enumerate pipelines — fleet "
            f"reconciliation needs a list-capable orchestrator")

    async def restart_pipeline(self, spec: ReplicatorSpec) -> None:
        await self.stop_pipeline(spec.pipeline_id)
        await self.start_pipeline(spec)

    async def scale_pipeline(self, spec: ReplicatorSpec,
                             shard_count: int) -> None:
        """Roll the deployment onto a new shard count (the autoscale
        controller's actuation seam, etl_tpu_torch/autoscale). Re-applies the
        spec with the new K: start_pipeline's own fan-out/reap semantics
        do the rest — one replica set (or subprocess) per shard, stale
        higher-index shards and rolled-back-to-unsharded fleets reaped,
        pods told their slice via shard/shard_count config keys. Must be
        called AFTER the ShardCoordinator's epoch flip: the store fence
        refuses any stale pod that outlives the roll, so ordering errors
        degrade to refused writes, never double ownership."""
        import dataclasses

        if shard_count < 1:
            raise EtlError(ErrorKind.CONFIG_INVALID,
                           f"shard_count must be >= 1, got {shard_count}")
        # strip a stale per-shard pin: the fan-out re-derives each pod's
        # `shard` key; carrying an old one would pin every pod to it
        base_config = {k: v for k, v in spec.config.items() if k != "shard"}
        base_config["shard_count"] = shard_count
        await self.start_pipeline(dataclasses.replace(
            spec, shard=None, shard_count=shard_count, config=base_config))

    async def delete_pipeline(self, pipeline_id: int) -> None:
        """Permanent teardown. Unlike stop (a pause, paired with start),
        delete may destroy pipeline-owned storage."""
        await self.stop_pipeline(pipeline_id)

    async def shutdown(self) -> None:
        return None


# config keys whose values are credentials: they move to the per-pipeline
# Secret and re-enter the replicator through the APP_ env overlay
# (reference k8s/base.rs create_or_update_{postgres,bigquery,clickhouse,
# iceberg,ducklake,snowflake}_secret — one seam per credential type; here
# one Secret whose keys are the env names)
_SECRET_KEYS = frozenset({
    "password", "private_key_pem", "token", "api_key", "catalog_token",
    "s3_access_key_id", "s3_secret_access_key", "service_account_key",
})


def split_secrets(config: dict) -> tuple[dict, dict[str, str]]:
    """(sanitized config, {APP_ env name: secret value}).

    Secret-valued keys are REMOVED from the config document that lands in
    the (world-readable) ConfigMap and injected back at runtime via the
    config loader's `APP_A__B` env overlay, sourced from the Secret."""
    env: dict[str, str] = {}

    def walk(doc: dict, path: tuple[str, ...]) -> dict:
        out = {}
        for k, v in doc.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
            elif k in _SECRET_KEYS and isinstance(v, str) and v:
                env["APP_" + "__".join(path + (k,)).upper()] = v
            else:
                out[k] = v
        return out

    return walk(config, ()), env


def derive_pod_status(doc: dict | None) -> str:
    """Kubernetes pod document → operational state (reference
    k8s/base.rs PodStatus: Stopped | Starting | Started | Stopping |
    Failed | Unknown), combining phase, deletion timestamp, and container
    states — readyReplicas alone cannot distinguish CrashLoopBackOff from
    a slow start."""
    if doc is None:
        return "stopped"
    if doc.get("metadata", {}).get("deletionTimestamp"):
        return "stopping"
    status = doc.get("status", {})
    phase = status.get("phase", "")
    for cs in status.get("containerStatuses", []):
        waiting = cs.get("state", {}).get("waiting", {})
        if waiting.get("reason") in ("CrashLoopBackOff", "ErrImagePull",
                                     "ImagePullBackOff"):
            return "failed"
        terminated = cs.get("state", {}).get("terminated", {})
        if terminated and terminated.get("exitCode", 0) != 0:
            return "failed"
    if phase == "Pending":
        return "starting"
    if phase == "Running":
        ready = all(cs.get("ready") for cs in
                    status.get("containerStatuses", [{"ready": False}]))
        return "started" if ready else "starting"
    if phase == "Succeeded":
        return "stopped"
    if phase == "Failed":
        return "failed"
    return "unknown"


class K8sOrchestrator(Orchestrator):
    """Creates Secret + ConfigMap + StatefulSet (and, for lake
    destinations, a maintenance CronJob) per pipeline, mirroring the
    reference resource layout (k8s/http.rs): credentials live in the
    Secret and reach the replicator as APP_ env vars, the sanitized
    config document rides the ConfigMap."""

    def __init__(self, *, api_url: str, namespace: str = "etl",
                 image: str = "etl-tpu-replicator:latest",
                 token: str = "", control_api_url: str = "",
                 control_api_key_secret: str = ""):
        self.api_url = api_url
        self.namespace = namespace
        self.image = image
        self.token = token
        # where maintenance jobs reach the CONTROL-PLANE API (etl-api) for
        # the stop/start pause gate — NOT the replicator pod, which serves
        # only /metrics + /health
        self.control_api_url = control_api_url
        # name of a deployer-managed Secret holding the control-plane
        # bearer token under key "api-key"; injected as ETL_API_KEY
        # (maintenance.py reads it) so secured APIs don't 401 every run
        self.control_api_key_secret = control_api_key_secret
        self._session: aiohttp.ClientSession | None = None

    #: probing bound for shard discovery (stop/delete/status find a
    #: sharded deployment's replica sets by walking `-s0, -s1, …` until
    #: the first 404; a fleet larger than this is not a thing this
    #: orchestrator ever creates)
    MAX_SHARDS = 64

    def _name(self, pipeline_id: int, shard: "int | None" = None) -> str:
        base = f"etl-replicator-{pipeline_id}"
        return base if shard is None else f"{base}-s{shard}"

    async def _api(self, method: str, path: str,
                   body: dict | None = None) -> tuple[int, dict]:
        if self._session is None:
            self._session = aiohttp.ClientSession()
        headers = {"Authorization": f"Bearer {self.token}"} if self.token \
            else {}
        data = None
        if body is not None:
            data = json.dumps(body).encode()
            # the k8s API rejects PATCH bodies that aren't declared as a
            # patch type (415); strategic merge matches the partial
            # template documents sent here
            headers["Content-Type"] = \
                "application/strategic-merge-patch+json" \
                if method == "PATCH" else "application/json"
        async with self._session.request(
                method, f"{self.api_url}{path}", data=data,
                headers=headers) as resp:
            text = await resp.text()
            try:
                doc = json.loads(text) if text else {}
            except json.JSONDecodeError:
                doc = {"raw": text}
            return resp.status, doc

    async def start_pipeline(self, spec: ReplicatorSpec) -> None:
        """Create (or roll) the pipeline's workload. shard_count > 1
        fans out to ONE replica set per shard — each pod's config names
        its `shard`/`shard_count` slice, so the replicator binary scopes
        itself (runtime/pipeline.py); a later start with a different K
        re-applies the new topology (the coordinator's epoch fence
        refuses any stale pod that outlives the roll)."""
        k = spec.effective_shard_count()
        if spec.shard is not None:
            await self._start_one(spec, spec.shard)
            return
        if k <= 1:
            await self._start_one(spec, None)
            # a deployment rolled back from sharded to unsharded must
            # not leave the old per-shard fleet running beside it
            # (discovery AFTER creation: scripted/409 re-apply flows see
            # the same request order as before sharding existed)
            for name in await self._shard_names(spec.pipeline_id):
                await self._stop_one(name)
            return
        import dataclasses

        for shard in range(k):
            shard_spec = dataclasses.replace(
                spec, shard=shard, shard_count=k,
                config=dict(spec.config, shard=shard, shard_count=k))
            await self._start_one(shard_spec, shard)
        # a resharded deployment must not leave the old unsharded
        # replica set — or, on a SHRINK, the higher-index shards — the
        # new fleet won't reuse running beside it (their slots would
        # pin WAL and their writes are only refused, never reaped)
        status, _ = await self._api(
            "DELETE", f"/apis/apps/v1/namespaces/{self.namespace}"
                      f"/statefulsets/{self._name(spec.pipeline_id)}")
        if status >= 400 and status != 404:
            raise EtlError(ErrorKind.DESTINATION_FAILED,
                           f"k8s DELETE stale unsharded set → {status}")
        wanted = {self._name(spec.pipeline_id, s) for s in range(k)}
        for name in await self._shard_names(spec.pipeline_id):
            if name not in wanted:
                await self._stop_one(name)

    async def _start_one(self, spec: ReplicatorSpec,
                         shard: "int | None") -> None:
        ns = self.namespace
        name = self._name(spec.pipeline_id, shard)
        sanitized, secret_env = split_secrets(spec.config)
        import time

        # fresh restarted-at template annotation on EVERY create-or-update:
        # a config/image change patches the pod template, and the changed
        # annotation makes the StatefulSet controller roll the pods even
        # when nothing else in the template moved (reference
        # k8s/http.rs:1676,1708 restart checksum)
        restarted_at = f"{time.time():.6f}"
        statefulset = ("POST",
                       f"/apis/apps/v1/namespaces/{ns}/statefulsets", {
            "metadata": {"name": name,
                         "labels": {"app": "etl-replicator",
                                    "pipeline_id": str(spec.pipeline_id),
                                    "tenant_id": spec.tenant_id,
                                    **({"shard": str(shard)}
                                       if shard is not None else {})}},
            "spec": {
                "serviceName": name, "replicas": 1,
                "selector": {"matchLabels": {"app": name}},
                "template": {
                    "metadata": {
                        "labels": {"app": name},
                        "annotations": {
                            "etl/restarted-at": restarted_at}},
                    "spec": {"containers": [{
                        "name": "replicator",
                        "image": spec.image or self.image,
                        "args": ["--config-dir", "/etc/etl"],
                        # credentials re-enter via the APP_ env
                        # overlay, never the config document
                        "envFrom": [{"secretRef": {
                            "name": f"{name}-secrets"}}],
                        "volumeMounts": [{"name": "config",
                                          "mountPath": "/etc/etl"}],
                    }], "volumes": [{
                        "name": "config",
                        "configMap": {"name": f"{name}-config"},
                    }]},
                },
            },
        })
        resources = [
            ("POST", f"/api/v1/namespaces/{ns}/secrets", {
                "metadata": {"name": f"{name}-secrets"},
                "stringData": secret_env,
            }),
            ("POST", f"/api/v1/namespaces/{ns}/configmaps", {
                "metadata": {"name": f"{name}-config"},
                # key MUST be base.yaml: the config loader reads
                # base.yaml/{env}.yaml from --config-dir (load.py), same
                # as LocalOrchestrator writes
                "data": {"base.yaml": yaml.safe_dump(sanitized),
                         "pipeline_id": str(spec.pipeline_id),
                         "tenant_id": spec.tenant_id},
            }),
            statefulset,
        ]
        if spec.config.get("destination", {}).get("type") == "lake":
            # lake pipelines: replicator + maintenance job operate on ONE
            # shared warehouse volume — without it each pod sees its own
            # empty pod-local filesystem and compaction is a no-op
            resources.insert(0, self._warehouse_pvc(spec, name))
            sts_spec = statefulset[2]["spec"]["template"]["spec"]
            sts_spec["volumes"].append({
                "name": "warehouse", "persistentVolumeClaim": {
                    "claimName": f"{name}-warehouse"}})
            sts_spec["containers"][0]["volumeMounts"].append({
                "name": "warehouse",
                "mountPath": self._warehouse_mount(spec)})
            # per-pipeline external-maintenance CronJob (reference
            # k8s/base.rs create_or_update_ducklake_maintenance)
            resources.append(self._maintenance_cronjob(spec, name))
        for method, path, body in resources:
            status, _ = await self._api(method, path, body)
            if status == 409:  # resource exists → update strategy below
                obj_path = f"{path}/{body['metadata']['name']}"
                if "/secrets" in path or "/configmaps" in path:
                    # REPLACE, don't merge: a strategic-merge PATCH keeps
                    # stale keys alive, so a rotated-away credential (or a
                    # pre-upgrade full-config blob) would keep reaching
                    # pods through envFrom forever. PUT replaces the
                    # object atomically — no delete-to-create window in
                    # which a concurrently starting pod would fail
                    # envFrom/volume resolution
                    status, _ = await self._api("PUT", obj_path, body)
                elif "persistentvolumeclaims" in path:
                    # reconcile the size: volume EXPANSION is a legal PVC
                    # update, and silently keeping the old claim would
                    # drop an operator's warehouse_size raise on restart.
                    # 403/422 = shrink or no-expansion storage class —
                    # keep the existing claim rather than fail the start
                    status, _ = await self._api("PATCH", obj_path, {
                        "spec": {"resources": body["spec"]["resources"]}})
                    if status in (403, 422):
                        status = 200
                else:
                    # StatefulSet/CronJob: strategic-merge PATCH rolls the
                    # pod template without recreating the workload
                    status, _ = await self._api("PATCH", obj_path, body)
            if status >= 400:
                raise EtlError(ErrorKind.DESTINATION_FAILED,
                               f"k8s {method} {path} → {status}")

    @staticmethod
    def _warehouse_mount(spec: ReplicatorSpec) -> str:
        # warehouse_path is a DIRECTORY (parquet files + catalog,
        # lake.py:52) — mount the shared volume exactly there
        return spec.config.get("destination", {}).get(
            "warehouse_path", "") or "/var/lib/etl/warehouse"

    def _warehouse_pvc(self, spec: ReplicatorSpec,
                       name: str) -> tuple[str, str, dict]:
        size = spec.config.get("destination", {}).get(
            "warehouse_size", "10Gi")
        return (
            "POST",
            f"/api/v1/namespaces/{self.namespace}/persistentvolumeclaims", {
                "metadata": {"name": f"{name}-warehouse"},
                "spec": {
                    "accessModes": ["ReadWriteOnce"],
                    "resources": {"requests": {"storage": size}},
                },
            })

    def _maintenance_cronjob(self, spec: ReplicatorSpec,
                             name: str) -> tuple[str, str, dict]:
        maint = spec.config.get("maintenance", {})
        schedule = maint.get("schedule", "*/30 * * * *")
        # --warehouse must equal the volume mountPath (including the
        # fallback when warehouse_path is unset) or the job would compact
        # an unmounted pod-local directory
        args = ["--warehouse", self._warehouse_mount(spec),
                "--pipeline-id", str(spec.pipeline_id)]
        if maint.get("coordination"):
            # lease-based coordination rides the SHARED warehouse catalog
            # (the replicator runs the agent side) — no API round-trip
            args.append("--coordinate")
        env = []
        if not maint.get("coordination") and self.control_api_url:
            # uncoordinated pipelines fall back to the stop/start pause
            # gate, which talks to the CONTROL-PLANE API with the
            # pipeline's tenant identity — and its bearer token, when the
            # deployer secured the API (401s would otherwise fail every
            # scheduled run, silently stopping compaction)
            args += ["--api-url", self.control_api_url,
                     "--tenant-id", spec.tenant_id]
            if self.control_api_key_secret:
                env.append({"name": "ETL_API_KEY", "valueFrom": {
                    "secretKeyRef": {"name": self.control_api_key_secret,
                                     "key": "api-key"}}})
        # with neither coordination nor a control-plane URL the job runs
        # ungated — lake catalog writes are transactional, so the risk is
        # churn, not corruption
        return (
            "POST",
            f"/apis/batch/v1/namespaces/{self.namespace}/cronjobs", {
                "metadata": {"name": f"{name}-maintenance",
                             "labels": {"app": "etl-maintenance",
                                        "pipeline_id":
                                            str(spec.pipeline_id)}},
                "spec": {
                    "schedule": schedule,
                    # explicit False: start_pipeline's 409→PATCH path must
                    # UNSUSPEND a CronJob that stop_pipeline suspended
                    "suspend": False,
                    "concurrencyPolicy": "Forbid",
                    "jobTemplate": {"spec": {"template": {"spec": {
                        "restartPolicy": "Never",
                        # the warehouse PVC is ReadWriteOnce: it can only
                        # attach to one node, so pin the job to whatever
                        # node runs the replicator pod
                        "affinity": {"podAffinity": {
                            "requiredDuringSchedulingIgnoredDuringExecution":
                            [{"labelSelector": {"matchLabels": {
                                "app": name}},
                              "topologyKey": "kubernetes.io/hostname"}]}},
                        "containers": [{
                            "name": "maintenance",
                            "image": spec.image or self.image,
                            # explicit command: the image's entrypoint is
                            # the REPLICATOR; the job must run the
                            # maintenance module regardless
                            "command": ["python", "-m",
                                        "etl_tpu_torch.maintenance"],
                            "args": args,
                            "env": env,
                            "volumeMounts": [{
                                "name": "warehouse",
                                "mountPath": self._warehouse_mount(spec)}],
                        }],
                        "volumes": [{
                            "name": "warehouse",
                            "persistentVolumeClaim": {
                                "claimName": f"{name}-warehouse"}}],
                    }}}},
                },
            })

    async def restart_pipeline(self, spec: ReplicatorSpec) -> None:
        """Rolling restart, NOT the base class's delete+recreate: re-apply
        the resource triple — the fresh restarted-at template annotation
        makes the StatefulSet controller roll the pods even when the
        config did not change (`kubectl rollout restart` semantics,
        reference k8s/http.rs:1676,1708)."""
        await self.start_pipeline(spec)

    async def _shard_names(self, pipeline_id: int) -> "list[str]":
        """Discover a deployment's per-shard replica-set names by walking
        `-s0, -s1, …` until the first absent StatefulSet — stop/delete/
        status need the live topology without being told K (the caller
        may not know it, e.g. after a rebalance changed it)."""
        ns = self.namespace
        # preferred: ONE labelSelector list — gap-proof (a half-finished
        # teardown that already removed -s0 must not hide -s1/-s2)
        status, doc = await self._api(
            "GET", f"/apis/apps/v1/namespaces/{ns}/statefulsets"
                   f"?labelSelector=pipeline_id%3D{pipeline_id}")
        if status < 400 and isinstance(doc, dict) \
                and isinstance(doc.get("items"), list):
            base = self._name(pipeline_id)
            names = []
            for item in doc["items"]:
                name = item.get("metadata", {}).get("name", "")
                if name.startswith(f"{base}-s") \
                        and name[len(base) + 2:].isdigit():
                    names.append(name)
            return sorted(names,
                          key=lambda n: int(n.rsplit("-s", 1)[1]))
        # fallback (API servers/stubs without list support): walk the
        # deterministic names until the first absent set
        names = []
        for shard in range(self.MAX_SHARDS):
            name = self._name(pipeline_id, shard)
            status, doc = await self._api(
                "GET", f"/apis/apps/v1/namespaces/{ns}/statefulsets/{name}")
            if status == 404:
                break
            if status >= 400:
                raise EtlError(ErrorKind.DESTINATION_FAILED,
                               f"k8s GET statefulset {name} → {status}")
            if not isinstance(doc, dict) \
                    or not ({"metadata", "spec"} & set(doc)):
                # a real StatefulSet document always carries metadata —
                # an empty 200 is a permissive stub/proxy, not a replica
                # set; treat it as absent rather than fabricating shards
                break
            names.append(name)
        return names

    async def _stop_one(self, name: str) -> None:
        ns = self.namespace
        for path in (f"/apis/apps/v1/namespaces/{ns}/statefulsets/{name}",
                     f"/api/v1/namespaces/{ns}/secrets/{name}-secrets",
                     f"/api/v1/namespaces/{ns}/configmaps/{name}-config"):
            status, _ = await self._api("DELETE", path)
            if status >= 400 and status != 404:
                raise EtlError(ErrorKind.DESTINATION_FAILED,
                               f"k8s DELETE {path} → {status}")
        # SUSPEND (not delete) the maintenance CronJob: a scheduled run
        # against a paused pipeline would otherwise auto-restart it via
        # the pause gate's finally-/start; start_pipeline's re-apply sets
        # suspend back to False. 404 = non-lake pipeline, fine.
        status, _ = await self._api(
            "PATCH",
            f"/apis/batch/v1/namespaces/{ns}/cronjobs/{name}-maintenance",
            {"spec": {"suspend": True}})
        if status >= 400 and status != 404:
            raise EtlError(ErrorKind.DESTINATION_FAILED,
                           f"k8s suspend cronjob {name} → {status}")

    async def stop_pipeline(self, pipeline_id: int) -> None:
        """Pause: remove the workload resources but KEEP the warehouse
        PVC and the maintenance CronJob. Stop is paired with start: the
        lake data must survive the pause (run_maintenance itself stops
        the pipeline before compacting the very warehouse that volume
        holds), and deleting the CronJob here would cascade-GC its OWN
        running Job mid-compaction — the pause gate calls /stop, and in
        real Kubernetes the Job's ownerReference makes the delete
        garbage-collect the pod that issued it. Sharded deployments stop
        EVERY shard's replica set (discovered, not assumed)."""
        shard_names = await self._shard_names(pipeline_id)
        await self._stop_one(self._name(pipeline_id))
        for name in shard_names:
            await self._stop_one(name)

    async def _delete_owned(self, name: str) -> None:
        ns = self.namespace
        for path in (f"/apis/batch/v1/namespaces/{ns}/cronjobs/"
                     f"{name}-maintenance",
                     f"/api/v1/namespaces/{ns}/persistentvolumeclaims/"
                     f"{name}-warehouse"):
            status, _ = await self._api("DELETE", path)
            if status >= 400 and status != 404:
                raise EtlError(ErrorKind.DESTINATION_FAILED,
                               f"k8s DELETE {path} → {status}")

    async def delete_pipeline(self, pipeline_id: int) -> None:
        """Permanent teardown: stop, then drop the maintenance CronJob
        and the warehouse PVC — an orphaned claim would be silently
        re-adopted by a future pipeline with the same id, running it
        against stale warehouse data (old catalog, old replay epochs).
        Sharded deployments tear down every shard's owned resources."""
        shard_names = await self._shard_names(pipeline_id)
        await self.stop_pipeline(pipeline_id)
        await self._delete_owned(self._name(pipeline_id))
        for name in shard_names:
            await self._delete_owned(name)

    async def list_pipelines(self) -> "dict[int, int]":
        """Enumerate the fleet from the StatefulSet inventory: one
        labelSelector list over `app=etl-replicator`, grouped by the
        `pipeline_id` label — shard count is the number of `-sN` replica
        sets (or 1 for an unsharded deployment)."""
        ns = self.namespace
        status, doc = await self._api(
            "GET", f"/apis/apps/v1/namespaces/{ns}/statefulsets"
                   f"?labelSelector=app%3Detl-replicator")
        if status >= 400 or not isinstance(doc, dict) \
                or not isinstance(doc.get("items"), list):
            raise EtlError(ErrorKind.DESTINATION_FAILED,
                           f"k8s LIST statefulsets → {status}")
        fleet: "dict[int, int]" = {}
        sharded: "dict[int, set]" = {}
        for item in doc["items"]:
            meta = item.get("metadata", {})
            labels = meta.get("labels", {})
            try:
                pid = int(labels.get("pipeline_id", ""))
            except ValueError:
                continue
            name = meta.get("name", "")
            base = self._name(pid)
            if name.startswith(f"{base}-s") \
                    and name[len(base) + 2:].isdigit():
                sharded.setdefault(pid, set()).add(name)
            elif name == base:
                fleet.setdefault(pid, 1)
        for pid, names in sharded.items():
            # a sharded deployment's per-shard sets win over a stale
            # unsharded one caught mid-roll
            fleet[pid] = len(names)
        return fleet

    async def probe_pod_health(self, pipeline_id: int,
                               app_name: "str | None" = None
                               ) -> "dict | None":
        """GET the replicator pod's live /health JSON through the API
        server's pod proxy (the in-cluster observability app,
        replicator.py build_observability_app). Returns the body dict —
        `{"status": "ok"|"degraded"|"faulted"|..., "reasons": {...}}` —
        or None when there is no pod / no proxy / no parseable body;
        callers treat None as "no evidence", never as failure."""
        ns = self.namespace
        name = app_name or self._name(pipeline_id)
        status, doc = await self._api(
            "GET", f"/api/v1/namespaces/{ns}/pods"
                   f"?labelSelector=app%3D{name}")
        if status >= 400:
            return None
        items = doc.get("items", []) if isinstance(doc, dict) else []
        pod_name = (items[0].get("metadata", {}).get("name", "")
                    if items else "")
        if not pod_name:
            return None
        status, body = await self._api(
            "GET", f"/api/v1/namespaces/{ns}/pods/{pod_name}"
                   f"/proxy/health")
        # 503 is a MEANINGFUL health answer (faulted/starting pods serve
        # it with a JSON body); only a transport-level miss is None
        if status == 404 or not isinstance(body, dict) \
                or "status" not in body:
            return None
        return body

    async def pod_status(self, pipeline_id: int,
                         app_name: "str | None" = None) -> str:
        """Pod-level state (reference get_replicator_pod_status): derives
        stopped/starting/started/stopping/failed/unknown from the pod
        document rather than StatefulSet replica counts. `app_name`
        selects one shard's replica set in a sharded deployment."""
        ns = self.namespace
        name = app_name or self._name(pipeline_id)
        status, doc = await self._api(
            "GET", f"/api/v1/namespaces/{ns}/pods"
                   f"?labelSelector=app%3D{name}")
        if status == 404:
            return "stopped"
        if status >= 400:
            return "unknown"
        items = doc.get("items", [])
        return derive_pod_status(items[0] if items else None)

    async def _status_one(self, pipeline_id: int,
                          name: str) -> ReplicatorStatus:
        ns = self.namespace
        status, doc = await self._api(
            "GET", f"/apis/apps/v1/namespaces/{ns}/statefulsets/{name}")
        if status == 404:
            return ReplicatorStatus(pipeline_id, "stopped")
        if status >= 400:
            return ReplicatorStatus(pipeline_id, "failed",
                                    f"k8s status {status}")
        pod = await self.pod_status(pipeline_id, app_name=name)
        if pod == "failed":
            return ReplicatorStatus(pipeline_id, "failed",
                                    "pod failed (see pod status)")
        ready = doc.get("status", {}).get("readyReplicas", 0)
        if not ready:
            return ReplicatorStatus(pipeline_id, "starting")
        # the pod is ready at the Kubernetes level — now ask the
        # REPLICATOR what it thinks: the live /health probe surfaces the
        # supervision health state readiness cannot see (a pod can be
        # Ready while its apply loop is faulted behind a dead heartbeat)
        health = await self.probe_pod_health(pipeline_id, app_name=name)
        if health is not None:
            h = str(health.get("status", ""))
            if h == "faulted":
                return ReplicatorStatus(
                    pipeline_id, "failed",
                    f"pod /health faulted: {health.get('fatal', '')}")
            if h == "degraded":
                reasons = health.get("reasons") or {}
                if isinstance(reasons, dict):
                    flat = tuple(f"{k}: {v}" for k, v in
                                 sorted(reasons.items()))
                else:
                    flat = (str(reasons),)
                return ReplicatorStatus(
                    pipeline_id, "running",
                    "degraded: " + "; ".join(flat), reasons=flat)
        return ReplicatorStatus(pipeline_id, "running")

    async def status(self, pipeline_id: int) -> ReplicatorStatus:
        """Aggregate over the deployment's replica sets: a sharded
        pipeline is `running` only when EVERY shard is; any failed shard
        fails the whole, any starting shard keeps it starting — one
        hidden dead shard must never read as healthy."""
        shard_names = await self._shard_names(pipeline_id)
        if not shard_names:
            return await self._status_one(pipeline_id,
                                          self._name(pipeline_id))
        states = []
        details = []
        reasons: list = []
        for i, name in enumerate(shard_names):
            st = await self._status_one(pipeline_id, name)
            states.append(st.state)
            details.append(f"s{i}={st.state}"
                           + (f" ({st.detail})" if st.detail else ""))
            reasons.extend(f"s{i} {r}" for r in st.reasons)
        detail = ", ".join(details)
        if any(s == "failed" for s in states):
            return ReplicatorStatus(pipeline_id, "failed", detail,
                                    reasons=tuple(reasons))
        if any(s in ("starting", "stopped") for s in states):
            return ReplicatorStatus(pipeline_id, "starting", detail,
                                    reasons=tuple(reasons))
        return ReplicatorStatus(pipeline_id, "running", detail,
                                reasons=tuple(reasons))

    async def shutdown(self) -> None:
        if self._session is not None:
            await self._session.close()
            self._session = None


class LocalOrchestrator(Orchestrator):
    """Runs `python -m etl_tpu_torch.replicator` subprocesses on this host.

    Sharded deployments (`shard_count` > 1 in the spec/config) run ONE
    subprocess per shard — keyed `(pipeline_id, shard)`; unsharded
    pipelines keep their plain `pipeline_id` key (and the existing
    restart-on-spec-change semantics). The shards share this host's
    ports, so shard s serves `/metrics` on `metrics_port` + s (a
    departure from the reference, whose local shards would all bind the
    one port)."""

    def __init__(self, work_dir: str):
        self.work_dir = Path(work_dir)
        # key: pipeline_id (unsharded) | (pipeline_id, shard) (sharded)
        self._procs: dict = {}
        self._specs: dict = {}

    def _keys_for(self, pipeline_id: int) -> list:
        return [k for k in self._procs
                if k == pipeline_id
                or (isinstance(k, tuple) and k[0] == pipeline_id)]

    async def start_pipeline(self, spec: ReplicatorSpec) -> None:
        k = spec.effective_shard_count()
        if spec.shard is None and k > 1:
            import dataclasses

            # a topology change (unsharded→K or K→K') stops whatever is
            # running under keys the new fleet won't reuse
            wanted = {(spec.pipeline_id, s) for s in range(k)}
            for key in self._keys_for(spec.pipeline_id):
                if key not in wanted:
                    await self._stop_key(key)
            for shard in range(k):
                config = dict(spec.config, shard=shard, shard_count=k)
                if config.get("metrics_port"):
                    # one host, one port space: shard s serves /metrics on
                    # the configured port plus s (a pod has its own)
                    config["metrics_port"] = int(config["metrics_port"]) \
                        + shard
                await self.start_pipeline(dataclasses.replace(
                    spec, shard=shard, shard_count=k, config=config))
            return
        key = spec.pipeline_id if spec.shard is None \
            else (spec.pipeline_id, spec.shard)
        existing = self._procs.get(key)
        if existing is not None and existing.returncode is None:
            if self._specs.get(key) == spec:
                return  # unchanged: keep the running process
            # config or image changed → restart with the new spec (the
            # single-host analogue of the StatefulSet template roll)
            await self._stop_key(key)
        suffix = "" if spec.shard is None else f"-s{spec.shard}"
        conf_dir = self.work_dir / f"pipeline-{spec.pipeline_id}{suffix}"
        conf_dir.mkdir(parents=True, exist_ok=True)
        (conf_dir / "base.yaml").write_text(yaml.safe_dump(spec.config))
        # logs go to a file: an unread PIPE would block the replicator once
        # the OS buffer fills (~64KB of log output)
        log = open(conf_dir / "replicator.log", "ab")
        try:
            proc = await asyncio.create_subprocess_exec(
                sys.executable, "-m", "etl_tpu_torch.replicator",
                "--config-dir", str(conf_dir),
                cwd=str(Path(__file__).resolve().parents[2]),
                stdout=log, stderr=asyncio.subprocess.STDOUT)
        finally:
            log.close()
        self._procs[key] = proc
        self._specs[key] = spec

    async def _stop_key(self, key) -> None:
        self._specs.pop(key, None)
        proc = self._procs.pop(key, None)
        if proc is None or proc.returncode is not None:
            return
        proc.send_signal(signal.SIGTERM)
        try:
            await asyncio.wait_for(proc.wait(), timeout=30)
        except asyncio.TimeoutError:
            proc.kill()
            await proc.wait()

    async def stop_pipeline(self, pipeline_id: int) -> None:
        for key in self._keys_for(pipeline_id):
            await self._stop_key(key)

    async def list_pipelines(self) -> "dict[int, int]":
        """Enumerate from the process table: shard count is the number
        of `(pipeline_id, shard)` keys (1 for an unsharded scalar key).
        Exited processes still count — presence is registration, health
        is `status()`'s job; the fleet reconciler must not re-create a
        pipeline just because its process crashed between ticks."""
        fleet: "dict[int, int]" = {}
        for key in self._procs:
            pid = key[0] if isinstance(key, tuple) else key
            fleet[pid] = fleet.get(pid, 0) + 1
        return fleet

    async def status(self, pipeline_id: int) -> ReplicatorStatus:
        keys = self._keys_for(pipeline_id)
        if not keys:
            return ReplicatorStatus(pipeline_id, "stopped")
        states = []
        details = []
        for key in sorted(keys, key=str):
            proc = self._procs[key]
            if proc.returncode is None:
                states.append("running")
            else:
                states.append("failed" if proc.returncode else "stopped")
                details.append(f"{key}: exit code {proc.returncode}")
        if any(s == "failed" for s in states):
            return ReplicatorStatus(pipeline_id, "failed",
                                    "; ".join(details))
        if all(s == "running" for s in states):
            return ReplicatorStatus(pipeline_id, "running")
        if all(s == "stopped" for s in states):
            return ReplicatorStatus(pipeline_id, "stopped",
                                    "; ".join(details))
        # mixed running/exited shard fleet: part of the publication is
        # still replicating — never report 'stopped' over a live process
        # (the K8s aggregate's stance: one incomplete shard degrades the
        # whole to 'starting')
        return ReplicatorStatus(pipeline_id, "starting",
                                "; ".join(details))

    async def shutdown(self) -> None:
        for key in list(self._procs):
            await self._stop_key(key)
