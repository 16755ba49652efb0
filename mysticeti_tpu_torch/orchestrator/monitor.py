"""Monitoring stack: prometheus + grafana provisioning for a benchmark fleet.

The port's copy of ``mysticeti_tpu.orchestrator.monitor``.

Capability parity with ``orchestrator/src/monitor.rs`` (:60-184), adapted to
this environment (no package installs): the orchestrator *generates* a ready
prometheus scrape config covering every node's /metrics endpoint plus a
grafana dashboard + datasource provisioning tree, and — when the binaries
happen to exist on the host — can launch prometheus directly.  The generated
tree is also exactly what the reference's grafana/prometheus containers mount.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import time
from typing import List, Optional

PROMETHEUS_PORT = 9090
GRAFANA_PORT = 3000


def prometheus_config(targets: List[str], scrape_interval_s: int = 5) -> str:
    """YAML scrape config for the node metric endpoints (monitor.rs:105-148)."""
    lines = [
        "global:",
        f"  scrape_interval: {scrape_interval_s}s",
        f"  evaluation_interval: {scrape_interval_s}s",
        "scrape_configs:",
        "  - job_name: mysticeti-nodes",
        "    static_configs:",
        "      - targets:",
    ]
    for t in targets:
        lines.append(f"          - {t}")
    return "\n".join(lines) + "\n"


def grafana_dashboard() -> dict:
    """The benchmark dashboard: tps, latency percentiles, verifier series
    (orchestrator/assets/grafana-dashboard.json equivalent, built for this
    framework's metric names)."""

    def panel(panel_id, title, expr, y):
        return {
            "id": panel_id,
            "title": title,
            "type": "timeseries",
            "datasource": "mysticeti-prometheus",
            "gridPos": {"h": 8, "w": 12, "x": (panel_id % 2) * 12, "y": y},
            "targets": [{"expr": expr, "refId": "A"}],
        }

    return {
        "title": "mysticeti-tpu benchmark",
        "uid": "mysticeti-tpu",
        "timezone": "utc",
        "refresh": "5s",
        "panels": [
            panel(0, "committed tx/s", "rate(latency_s_count[30s])", 0),
            panel(1, "avg latency (s)",
                  "rate(latency_s_sum[30s]) / rate(latency_s_count[30s])", 0),
            panel(2, "committed leaders/s", "rate(committed_leaders_total[30s])", 8),
            panel(3, "verified signatures/s",
                  "rate(verified_signatures_total[30s])", 8),
            panel(4, "verify batch size p90",
                  "histogram_quantile(0.9, rate(verify_batch_size_bucket[1m]))", 16),
            panel(5, "peer RTT p90",
                  "histogram_quantile(0.9, rate(connection_latency_bucket[1m]))", 16),
            # Fleet health plane (health.py): the "why was it slow" row.
            panel(6, "health: commit rate / round advance",
                  "mysticeti_health_commit_rate", 24),
            panel(7, "health: per-authority frontier lag",
                  "mysticeti_health_authority_lag_rounds", 24),
            panel(8, "health: SLO alerts by kind",
                  "rate(mysticeti_health_slo_alerts_total[1m])", 32),
            panel(9, "commit critical path p90 by stage",
                  "histogram_quantile(0.9, "
                  "rate(commit_critical_path_seconds_bucket[1m]))", 32),
        ],
    }


def grafana_provisioning(out_dir: str) -> None:
    """Write the grafana provisioning tree (datasource + dashboard provider)."""
    ds_dir = os.path.join(out_dir, "grafana", "provisioning", "datasources")
    db_dir = os.path.join(out_dir, "grafana", "provisioning", "dashboards")
    dash_dir = os.path.join(out_dir, "grafana", "dashboards")
    for d in (ds_dir, db_dir, dash_dir):
        os.makedirs(d, exist_ok=True)
    with open(os.path.join(ds_dir, "prometheus.yaml"), "w") as f:
        f.write(
            "apiVersion: 1\n"
            "datasources:\n"
            "  - name: mysticeti-prometheus\n"
            "    type: prometheus\n"
            f"    url: http://127.0.0.1:{PROMETHEUS_PORT}\n"
            "    isDefault: true\n"
        )
    with open(os.path.join(db_dir, "provider.yaml"), "w") as f:
        f.write(
            "apiVersion: 1\n"
            "providers:\n"
            "  - name: mysticeti\n"
            "    folder: ''\n"
            "    type: file\n"
            "    options:\n"
            "      path: /etc/grafana/dashboards\n"
        )
    with open(os.path.join(dash_dir, "mysticeti.json"), "w") as f:
        json.dump(grafana_dashboard(), f, indent=2)


class MonitoringStack:
    """Generate the monitoring tree; start prometheus when available."""

    GRAFANA_STARTUP_GRACE_S = 0.5

    def __init__(self, out_dir: str) -> None:
        self.out_dir = out_dir
        self.prometheus_proc: Optional[subprocess.Popen] = None
        self.grafana_proc: Optional[subprocess.Popen] = None

    def deploy(self, metric_targets: List[str]) -> str:
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, "prometheus.yaml")
        with open(path, "w") as f:
            f.write(prometheus_config(metric_targets))
        grafana_provisioning(self.out_dir)
        return path

    def start_prometheus(self) -> bool:
        """Launch a local prometheus against the generated config when the
        binary exists; returns False (config-only mode) otherwise."""
        binary = shutil.which("prometheus")
        if binary is None:
            return False
        self.prometheus_proc = subprocess.Popen(
            [
                binary,
                f"--config.file={os.path.join(self.out_dir, 'prometheus.yaml')}",
                f"--storage.tsdb.path={os.path.join(self.out_dir, 'tsdb')}",
                f"--web.listen-address=127.0.0.1:{PROMETHEUS_PORT}",
            ],
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )
        return True

    def start_grafana(self) -> bool:
        """Launch a local grafana against the generated provisioning tree when
        the binary exists (monitor.rs:86-104 ``start_grafana`` parity); returns
        False (config-only mode) otherwise.

        The reference runs the official container with the provisioning dir
        mounted; here the same tree is handed over through grafana's
        ``GF_PATHS_PROVISIONING`` environment override, and the dashboard
        provider path is rewritten to the generated ``grafana/dashboards``
        directory rather than the container's ``/etc/grafana/dashboards``.
        """
        binary = shutil.which("grafana-server") or shutil.which("grafana")
        if binary is None:
            return False
        grafana_dir = os.path.join(self.out_dir, "grafana")
        provider = os.path.join(
            grafana_dir, "provisioning", "dashboards", "provider.yaml")
        if os.path.exists(provider):
            text = open(provider).read().replace(
                "/etc/grafana/dashboards", os.path.join(grafana_dir, "dashboards"))
            with open(provider, "w") as f:
                f.write(text)
        env = dict(os.environ)
        env.update({
            "GF_PATHS_PROVISIONING": os.path.join(grafana_dir, "provisioning"),
            "GF_PATHS_DATA": os.path.join(grafana_dir, "data"),
            "GF_PATHS_LOGS": os.path.join(grafana_dir, "logs"),
            "GF_SERVER_HTTP_PORT": str(GRAFANA_PORT),
            "GF_AUTH_ANONYMOUS_ENABLED": "true",
        })
        # Grafana refuses to start without its homepath (conf/defaults.ini);
        # point it at the conventional install location when present.
        for home in ("/usr/share/grafana", "/opt/grafana"):
            if os.path.isdir(home):
                env["GF_PATHS_HOME"] = home
                break
        args = [binary] if binary.endswith("grafana-server") else [binary, "server"]
        self.grafana_proc = subprocess.Popen(
            args,
            env=env,
            cwd=env.get("GF_PATHS_HOME", grafana_dir),
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )
        # Liveness check: a misconfigured grafana exits within a moment, and
        # with stderr discarded a bare `return True` would report dashboards
        # up at :3000 with nothing listening.
        time.sleep(self.GRAFANA_STARTUP_GRACE_S)
        if self.grafana_proc.poll() is not None:
            self.grafana_proc = None
            return False
        return True

    # -- remote deployment (monitor.rs:60-105,184) --

    PROM_SESSION = "mysticeti-prometheus"
    GRAFANA_SESSION = "mysticeti-grafana"

    async def deploy_remote(
        self,
        ssh,
        host: str,
        metric_targets: List[str],
        remote_dir: str = "/tmp/mysticeti-monitoring",
    ) -> str:
        """Deploy the stack onto a DEDICATED monitoring instance over ssh —
        the reference configures and (re)starts prometheus + grafana on its
        monitoring instance through the ssh manager (monitor.rs:60-105; the
        grafana address accessor :184).  The locally generated tree (scrape
        config + dashboard provisioning) is uploaded verbatim; both services
        run as background sessions so `kill_session` tears them down.
        Returns the grafana URL on the monitoring host.
        """
        from .ssh import CommandContext

        self.deploy(metric_targets)
        await ssh.upload(
            host,
            [
                os.path.join(self.out_dir, "prometheus.yaml"),
                os.path.join(self.out_dir, "grafana"),
            ],
            remote_dir,
        )
        # The generated dashboard provider points at the container path
        # (/etc/grafana/dashboards); retarget it to the uploaded tree the
        # same way the local launcher does.
        provider = f"{remote_dir}/grafana/provisioning/dashboards/provider.yaml"
        await ssh.execute(
            host,
            f"sed -i 's#/etc/grafana/dashboards#{remote_dir}/grafana/"
            f"dashboards#' {provider}",
        )
        # Restart semantics: kill any previous sessions, then start fresh
        # against the uploaded config (monitor.rs re-runs its setup command
        # list on every deploy).
        await ssh.kill_session(host, self.PROM_SESSION)
        await ssh.execute(
            host,
            f"prometheus --config.file={remote_dir}/prometheus.yaml"
            f" --storage.tsdb.path={remote_dir}/tsdb"
            f" --web.listen-address=0.0.0.0:{PROMETHEUS_PORT}",
            CommandContext(
                background=self.PROM_SESSION,
                log_file=f"{remote_dir}/prometheus.log",
            ),
        )
        await ssh.kill_session(host, self.GRAFANA_SESSION)
        # Same binary-name and homepath tolerance as the local launcher
        # (grafana-server on older installs; GF_PATHS_HOME when a
        # conventional install dir exists).
        grafana_cmd = (
            f"GF_PATHS_PROVISIONING={remote_dir}/grafana/provisioning"
            f" GF_PATHS_DATA={remote_dir}/grafana/data"
            f" GF_SERVER_HTTP_PORT={GRAFANA_PORT}"
            f" GF_AUTH_ANONYMOUS_ENABLED=true"
            ' GF_PATHS_HOME="$([ -d /usr/share/grafana ] &&'
            " echo /usr/share/grafana)\""
            " sh -c 'command -v grafana-server >/dev/null 2>&1 &&"
            " exec grafana-server || exec grafana server'"
        )
        await ssh.execute(
            host,
            grafana_cmd,
            CommandContext(
                background=self.GRAFANA_SESSION,
                log_file=f"{remote_dir}/grafana.log",
            ),
        )
        # Liveness: a background spawn returns 0 whether or not the service
        # survived its first moment — verify both session pidgroups are
        # still alive (the remote analogue of start_grafana's local check).
        for session in (self.PROM_SESSION, self.GRAFANA_SESSION):
            pidfile = CommandContext(background=session).pidfile()
            await ssh.execute(
                host,
                f"sleep 1; kill -0 -$(cat {pidfile})",
            )
        return f"http://{host.split('@')[-1]}:{GRAFANA_PORT}"

    async def stop_remote(self, ssh, host: str) -> None:
        await ssh.kill_session(host, self.PROM_SESSION)
        await ssh.kill_session(host, self.GRAFANA_SESSION)

    def stop(self) -> None:
        for attr in ("prometheus_proc", "grafana_proc"):
            proc = getattr(self, attr)
            setattr(self, attr, None)
            if proc is None:
                continue
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
