"""Dashboard — HTTP JSON state API + a minimal HTML overview.

Reference surface: the dashboard head + state API endpoints
(ray: python/ray/dashboard/ — aiohttp modules serving cluster state to
the UI; python/ray/util/state/ backs the same verbs). Here: a threaded
HTTP server over ray_tpu_torch.util.state and the metrics renderer — the
machine-readable surface an external UI or poller needs.
"""

from __future__ import annotations

import http.server
import json
import threading
import time
from typing import Optional

# Single-file vanilla-JS overview UI (reference role: the dashboard
# React app; here dependency-free so it works offline). Live stat
# tiles + nodes/actors/task-summary tables + a throughput line chart
# sampled client-side from /api/summary deltas, auto-refreshing.
_INDEX = """<!doctype html>
<html><head><meta charset="utf-8">
<title>ray_tpu_torch dashboard</title>
<style>
.viz-root {
  color-scheme: light;
  --surface-1: #fcfcfb; --surface-2: #f1f0ee;
  --text-primary: #0b0b0b; --text-secondary: #52514e;
  --series-1: #2a78d6; --grid: #e4e2de;
  --good: #0ca30c; --critical: #d03b3b;
}
@media (prefers-color-scheme: dark) {
  :root:where(:not([data-theme="light"])) .viz-root {
    color-scheme: dark;
    --surface-1: #1a1a19; --surface-2: #242423;
    --text-primary: #ffffff; --text-secondary: #c3c2b7;
    --series-1: #3987e5; --grid: #343432;
  }
}
body { margin: 0; }
.viz-root {
  font: 13px/1.45 system-ui, sans-serif; background: var(--surface-1);
  color: var(--text-primary); min-height: 100vh; padding: 20px 24px;
  box-sizing: border-box;
}
h1 { font-size: 16px; margin: 0 0 2px; }
.sub { color: var(--text-secondary); margin-bottom: 16px; }
.tiles { display: flex; flex-wrap: wrap; gap: 12px; margin-bottom: 18px; }
.tile {
  background: var(--surface-2); border-radius: 8px; padding: 10px 16px;
  min-width: 108px;
}
.tile .v { font-size: 22px; font-weight: 600; font-variant-numeric: tabular-nums; }
.tile .k { color: var(--text-secondary); font-size: 12px; }
.panel { margin-bottom: 20px; }
.panel h2 { font-size: 13px; margin: 0 0 6px; color: var(--text-secondary);
  font-weight: 600; text-transform: uppercase; letter-spacing: .04em; }
table { border-collapse: collapse; width: 100%; max-width: 880px; }
th, td { text-align: left; padding: 4px 12px 4px 0; border-bottom: 1px solid var(--grid);
  font-variant-numeric: tabular-nums; }
th { color: var(--text-secondary); font-weight: 500; }
/* state badges: a CSS-class dot per known state, so no cell value is
   ever rendered as markup */
td[class^="st-"]::before { content: ""; display: inline-block; width: 8px;
  height: 8px; border-radius: 50%; margin-right: 6px;
  vertical-align: baseline; background: var(--critical); }
td.st-alive::before, td.st-running::before,
td.st-finished::before { background: var(--good); }
.links a { color: var(--text-secondary); margin-right: 10px; }
#logfiles a { color: var(--series-1); margin-right: 14px;
  text-decoration: none; }
#logview { background: var(--surface-2); border-radius: 8px;
  padding: 10px 14px; max-width: 880px; max-height: 320px;
  overflow: auto; white-space: pre-wrap; font: 12px/1.4 ui-monospace,
  monospace; display: none; }
#chartwrap { position: relative; max-width: 880px; }
/* task latency breakdown bar: dep-wait | queue | exec segments */
.bd { display: inline-flex; width: 140px; height: 8px; border-radius: 4px;
  overflow: hidden; background: var(--surface-2); vertical-align: middle; }
.bd span { display: block; height: 100%; }
.bd-dep { background: var(--grid); }
.bd-q { background: var(--text-secondary); }
.bd-ex { background: var(--series-1); }
#tp-tip { position: absolute; pointer-events: none; display: none;
  background: var(--surface-2); border: 1px solid var(--grid);
  border-radius: 6px; padding: 4px 8px; font-size: 12px; }
</style></head>
<body><div class="viz-root">
<h1>ray_tpu_torch</h1>
<div class="sub" id="addr">cluster overview &middot; refreshes every 2s</div>
<div class="tiles" id="tiles"></div>
<div class="panel"><h2>Task throughput (finished/s)</h2>
  <div id="chartwrap"><svg id="tp" width="880" height="120"
    role="img" aria-label="tasks finished per second over the last two minutes"></svg>
  <div id="tp-tip"></div></div></div>
<div class="panel"><h2>Utilization</h2>
<div class="sub">per-node resource series from the profile plane
&middot; <a href="/api/flamegraph" download="profile.speedscope.json"
id="fg-link">download flamegraph (speedscope json)</a></div>
<div id="util"></div></div>
<div class="panel"><h2>Nodes</h2><div id="nodes"></div></div>
<div class="panel"><h2>Task summary</h2><div id="tasks"></div></div>
<div class="panel"><h2>Recent tasks (dep-wait &middot; queue &middot; exec)</h2>
<div id="taskdetail"></div></div>
<div class="panel"><h2>Tenants</h2>
<div class="sub">QoS plane fair-share state per tenant (empty when the
plane is off, qos=False)</div>
<div id="tenants"></div></div>
<div class="panel"><h2>Serving</h2>
<div class="sub">prefill/decode pools: TTFT percentiles, KV-affinity
hit rate, SLO sheds (empty when serve never started)</div>
<div id="serve"></div></div>
<div class="panel"><h2>Traces</h2><div id="traces"></div></div>
<div class="panel"><h2>Actors</h2><div id="actors"></div></div>
<div class="panel"><h2>Data streams</h2><div id="streams"></div></div>
<div class="panel"><h2>Logs</h2><div id="logfiles" class="sub"></div>
<pre id="logview"></pre></div>
<div class="panel links"><h2>Raw endpoints</h2>
<a href="/api/summary">summary</a><a href="/api/tasks">tasks</a>
<a href="/api/actors">actors</a><a href="/api/objects">objects</a>
<a href="/api/nodes">nodes</a><a href="/api/placement_groups">pgs</a>
<a href="/api/tenants">tenants</a>
<a href="/api/serve">serve</a>
<a href="/api/data_streams">streams</a>
<a href="/api/task_events">task_events</a>
<a href="/api/timeline">timeline</a>
<a href="/api/traces">traces</a>
<a href="/api/utilization">utilization</a>
<a href="/api/profile_stacks">profile_stacks</a>
<a href="/api/flamegraph">flamegraph</a>
<a href="/api/logs">logs</a>
<a href="/api/jobs">jobs</a><a href="/metrics">metrics</a></div>
<script>
"use strict";
let lastFinished = null, lastT = null;
const rates = [];         // [{t, rate}] samples for the line chart

function esc(v) {
  return String(v).replace(/&/g, "&amp;").replace(/</g, "&lt;")
    .replace(/>/g, "&gt;").replace(/"/g, "&quot;");
}

function tile(k, v, color) {
  return `<div class="tile"><div class="v"${color ?
    ` style="color:var(--${color})"` : ""}>${v}</div>
    <div class="k">${k}</div></div>`;
}

function rows(list, cols, stateCols) {
  if (!list || !list.length) {
    return '<div class="sub">none</div>';
  }
  const head = cols.map(c => `<th>${c}</th>`).join("");
  const body = list.map(r =>
    `<tr>${cols.map(c => {
      const v = r[c] ?? "";
      // cluster data (actor names, node states, resource keys) must
      // never become markup in the operator's browser: EVERY cell is
      // escaped; state badges are pure CSS keyed on a validated class
      if (stateCols && stateCols.includes(c)) {
        const cls = /^[a-z_]+$/.test(String(v).toLowerCase()) ?
          String(v).toLowerCase() : "other";
        return `<td class="st-${cls}">${esc(v)}</td>`;
      }
      return `<td>${esc(v)}</td>`;
    }).join("")}</tr>`
  ).join("");
  return `<table><thead><tr>${head}</tr></thead><tbody>${body}</tbody></table>`;
}

function fmtS(v) {
  v = Number(v) || 0;
  return v >= 1 ? v.toFixed(2) + "s" : (v * 1000).toFixed(1) + "ms";
}

function taskDetailRows(list) {
  // FINISHED/FAILED ring rows, newest first, with a latency breakdown
  // bar per row. Durations pass through Number() and names/states
  // through esc() — ring content never renders as markup.
  const done = (list || []).filter(r => r.end_at)
    .sort((a, b) => (b.end_at || 0) - (a.end_at || 0)).slice(0, 25);
  if (!done.length) { return '<div class="sub">none yet</div>'; }
  const head = ["task", "state", "node", "attempt", "tier", "dep-wait",
                "queue", "exec", "breakdown", "error"]
    .map(c => `<th>${c}</th>`).join("");
  const body = done.map(r => {
    const d = Number(r.dep_wait_s) || 0, q = Number(r.queue_s) || 0,
          ex = Number(r.exec_s) || 0;
    const tot = (d + q + ex) || 1;
    const bar = '<div class="bd">' +
      [["bd-dep", d], ["bd-q", q], ["bd-ex", ex]].map(([cls, v]) =>
        `<span class="${cls}" style="width:${
          (100 * v / tot).toFixed(1)}%"></span>`).join("") + "</div>";
    const cls = /^[a-z_]+$/.test(String(r.state).toLowerCase()) ?
      String(r.state).toLowerCase() : "other";
    return `<tr><td>${esc(r.name)}</td>` +
      `<td class="st-${cls}">${esc(r.state)}</td>` +
      `<td>${Number(r.node_index)}</td>` +
      `<td>${Number(r.attempt) || 0}</td>` +
      `<td>${Number(r.tier) || 0}</td>` +
      `<td>${fmtS(d)}</td><td>${fmtS(q)}</td><td>${fmtS(ex)}</td>` +
      `<td>${bar}</td><td>${esc(r.error_type || "")}</td></tr>`;
  }).join("");
  return `<table><thead><tr>${head}</tr></thead>` +
    `<tbody>${body}</tbody></table>`;
}

function spark(points, w, h) {
  // inline sparkline for one utilization series (numbers only — no
  // cluster strings enter the markup)
  if (!points || points.length < 2) { return ""; }
  const vs = points.map(p => Number(p[1]) || 0);
  const vmax = Math.max(...vs), vmin = Math.min(...vs, 0);
  const x = i => 1 + (w - 2) * i / (points.length - 1);
  const y = v => h - 2 - (h - 4) * (v - vmin) / ((vmax - vmin) || 1);
  let d = "";
  vs.forEach((v, i) => {
    d += (i ? "L" : "M") + x(i).toFixed(1) + " " + y(v).toFixed(1);
  });
  return `<svg width="${w}" height="${h}" role="img"><path d="${d}"
    fill="none" stroke="var(--series-1)" stroke-width="1.5"
    stroke-linejoin="round"/></svg>`;
}

function fmtBytes(v) {
  v = Number(v) || 0;
  return v >= 1 << 30 ? (v / (1 << 30)).toFixed(1) + "GB"
    : (v / (1 << 20)).toFixed(0) + "MB";
}

function utilRows(util) {
  if (!util || !util.length) {
    return '<div class="sub">no samples (head runs with profile_hz=0)</div>';
  }
  const series = ["cpu_percent", "rss_bytes", "arena_used_bytes"];
  const byNode = {};
  for (const r of util) {
    (byNode[r.node] = byNode[r.node] || {})[r.series] = r;
  }
  const head = ["node", ...series].map(c => `<th>${esc(c)}</th>`).join("");
  const body = Object.keys(byNode).sort((a, b) => a - b).map(n => {
    const cells = series.map(s => {
      const r = byNode[n][s];
      if (!r || !r.points.length) { return "<td>–</td>"; }
      const last = Number(r.points[r.points.length - 1][1]) || 0;
      const label = s === "cpu_percent" ? last.toFixed(1) + "%"
        : fmtBytes(last);
      return `<td>${spark(r.points.slice(-48), 140, 26)} ${label}</td>`;
    }).join("");
    return `<tr><td>${Number(n)}</td>${cells}</tr>`;
  }).join("");
  return `<table><thead><tr>${head}</tr></thead><tbody>${body}</tbody></table>`;
}

function drawChart() {
  const svg = document.getElementById("tp");
  const W = svg.clientWidth || 880, H = 120, PAD = 28;
  const pts = rates.slice(-60);
  if (pts.length < 2) { svg.innerHTML = ""; return; }
  const vmax = Math.max(1, ...pts.map(p => p.rate));
  const x = i => PAD + (W - PAD - 8) * i / (pts.length - 1);
  const y = v => (H - 18) - (H - 26) * v / vmax;
  let d = "";
  pts.forEach((p, i) => { d += (i ? "L" : "M") + x(i).toFixed(1) + " " + y(p.rate).toFixed(1); });
  // recessive grid: three horizontal rules + axis labels in text tokens
  const gy = [0, vmax / 2, vmax];
  svg.innerHTML =
    gy.map(v => `<line x1="${PAD}" x2="${W - 8}" y1="${y(v)}" y2="${y(v)}"
      stroke="var(--grid)" stroke-width="1"/>`).join("") +
    gy.map(v => `<text x="${PAD - 6}" y="${y(v) + 4}" text-anchor="end"
      fill="var(--text-secondary)" font-size="10">${v.toFixed(0)}</text>`).join("") +
    `<path d="${d}" fill="none" stroke="var(--series-1)" stroke-width="2"
      stroke-linejoin="round" stroke-linecap="round"/>` +
    `<line id="xh" y1="8" y2="${H - 18}" stroke="var(--grid)" stroke-width="1"
      visibility="hidden"/>` +
    `<circle id="hp" r="4" fill="var(--series-1)" stroke="var(--surface-1)"
      stroke-width="2" visibility="hidden"/>`;
  svg.onmousemove = (ev) => {
    const r = svg.getBoundingClientRect();
    const i = Math.max(0, Math.min(pts.length - 1,
      Math.round((ev.clientX - r.left - PAD) / ((W - PAD - 8) / (pts.length - 1)))));
    const p = pts[i];
    document.getElementById("xh").setAttribute("x1", x(i));
    document.getElementById("xh").setAttribute("x2", x(i));
    document.getElementById("xh").setAttribute("visibility", "visible");
    const hp = document.getElementById("hp");
    hp.setAttribute("cx", x(i)); hp.setAttribute("cy", y(p.rate));
    hp.setAttribute("visibility", "visible");
    const tip = document.getElementById("tp-tip");
    tip.style.display = "block";
    tip.style.left = Math.min(x(i) + 10, W - 150) + "px";
    tip.style.top = "8px";
    tip.textContent = new Date(p.t * 1000).toLocaleTimeString() +
      "  " + p.rate.toFixed(1) + " tasks/s";
  };
  svg.onmouseleave = () => {
    document.getElementById("tp-tip").style.display = "none";
    for (const id of ["xh", "hp"])
      document.getElementById(id).setAttribute("visibility", "hidden");
  };
}

// Log viewer: file list is built with DOM nodes and the file body is
// assigned via textContent — log content (worker prints, tracebacks)
// can never render as markup (same escaping discipline as esc()).
async function refreshLogs() {
  const files = await fetch("/api/logs").then(r => r.json());
  const el = document.getElementById("logfiles");
  el.replaceChildren();
  if (!files.length) { el.textContent = "no log files"; return; }
  for (const f of files.slice(0, 60)) {
    const a = document.createElement("a");
    a.href = "#";
    a.textContent = f.filename + " · " + f.size_bytes + "B · " +
      String(f.node_id || "").slice(0, 8);
    a.onclick = (ev) => { ev.preventDefault(); viewLog(f); };
    el.appendChild(a);
  }
}

async function viewLog(f) {
  const r = await fetch("/api/log_file?filename=" +
    encodeURIComponent(f.filename) + "&node_id=" +
    encodeURIComponent(f.node_id || "") + "&tail=500")
    .then(r => r.json());
  const pre = document.getElementById("logview");
  pre.style.display = "block";
  pre.textContent = "--- " + f.filename + " ---\n" +
    (r.lines ? r.lines.join("\n") : "error: " + r.error);
}

async function refresh() {
  try {
    const [s, actors, taskEvents, traces, util, tenants, serve] =
      await Promise.all([
      fetch("/api/summary").then(r => r.json()),
      fetch("/api/actors").then(r => r.json()),
      fetch("/api/task_events").then(r => r.json()).catch(() => []),
      fetch("/api/traces").then(r => r.json()).catch(() => []),
      fetch("/api/utilization").then(r => r.json()).catch(() => []),
      fetch("/api/tenants").then(r => r.json()).catch(() => []),
      fetch("/api/serve").then(r => r.json()).catch(() => null),
    ]);
    refreshLogs().catch(() => {});
    const nodes = s.nodes || [];
    document.getElementById("addr").textContent =
      "cluster overview \u00b7 refreshes every 2s";
    const t = s.tasks || {};
    const sched = s.scheduler || {};
    const finished = sched.finished ?? t.FINISHED_TOTAL ?? 0;
    if (lastFinished !== null && s.time > lastT) {
      rates.push({t: s.time,
                  rate: Math.max(0, (finished - lastFinished) / (s.time - lastT))});
      if (rates.length > 120) rates.shift();
    }
    lastFinished = finished; lastT = s.time;
    const aliveNodes = nodes.filter(n => (n.state || "ALIVE") === "ALIVE").length;
    const aliveActors = s.actors_alive ?? 0;
    document.getElementById("tiles").innerHTML =
      tile("nodes alive", aliveNodes + "/" + nodes.length,
           aliveNodes === nodes.length ? "good" : "critical") +
      tile("actors alive", aliveActors) +
      tile("deps waiting", sched.waiting_deps ?? 0) +
      tile("ready queue", sched.ready_queue ?? 0) +
      tile("tasks running", sched.running ??
           Math.max(0, (sched.dispatched ?? 0) - finished)) +
      tile("tasks finished", finished) +
      tile("tasks/s", rates.length ? rates[rates.length - 1].rate.toFixed(1) : "–") +
      tile("ingest overlap", (s.data_streams || []).length ?
           (100 * (s.data_streams[s.data_streams.length - 1]
                     .overlap_fraction || 0)).toFixed(0) + "%" : "–");
    const ring = s.control_ring;
    if (ring) {
      document.getElementById("tiles").innerHTML +=
        tile("ring msgs", ring.msgs ?? 0) +
        tile("ring bytes", fmtBytes(ring.bytes ?? 0)) +
        tile("ring fallbacks", ring.fallback ?? 0,
             ring.fallback ? "critical" : null) +
        tile("ring full-waits", ring.full_waits ?? 0);
    }
    document.getElementById("util").innerHTML = utilRows(util);
    const lat = s.task_latency;
    if (lat && lat.n) {
      document.getElementById("tiles").innerHTML +=
        tile("exec p50 / p95",
             fmtS(lat.exec_p50_s) + " / " + fmtS(lat.exec_p95_s)) +
        tile("queue p50 / p95",
             fmtS(lat.queue_p50_s) + " / " + fmtS(lat.queue_p95_s)) +
        tile("tasks failed", lat.failed_total,
             lat.failed_total ? "critical" : null) +
        tile("retries", lat.retries_total,
             lat.retries_total ? "critical" : null);
    }
    document.getElementById("taskdetail").innerHTML =
      taskDetailRows(taskEvents);
    // QoS plane: weighted fair-share state per tenant; deficit > 0
    // means the tenant is running behind its share
    document.getElementById("tenants").innerHTML = rows(
      (tenants || []).map(tn => ({
        tenant: tn.tenant, weight: tn.weight,
        share: (100 * (tn.share || 0)).toFixed(0) + "%",
        deficit: Number(tn.deficit || 0).toFixed(1),
        served: tn.served ?? 0, queued: tn.queued ?? 0,
        running: tn.running ?? 0, preempted: tn.preempted ?? 0,
      })), ["tenant", "weight", "share", "deficit", "served",
            "queued", "running", "preempted"]);
    // serving plane: plane-wide tiles + one row per deployment; the
    // affinity hit rate only counts follow-up turns (first-ever
    // session turns are neither hit nor miss)
    const deps = (serve && serve.deployments) || [];
    if (deps.length || (serve && serve.streams)) {
      const aff = (serve.affinity_hit || 0) + (serve.affinity_miss || 0);
      document.getElementById("serve").innerHTML =
        tile("streams", serve.streams || 0) +
        tile("TTFT p50 / p95", fmtS(serve.ttft_p50) + " / " +
             fmtS(serve.ttft_p95)) +
        tile("affinity hits", aff ? (100 * (serve.affinity_hit || 0) /
             aff).toFixed(0) + "%" : "–") +
        tile("SLO sheds", serve.admission_shed || 0,
             serve.admission_shed ? "critical" : null) +
        tile("KV moved", fmtBytes(serve.kv_bytes || 0)) +
        tile("resumed", serve.resumed || 0,
             serve.resumed ? "critical" : null) +
        rows(deps.map(d => ({
          deployment: d.name, replicas: d.replicas,
          ongoing: d.ongoing, sessions: d.sessions,
          autoscaling: d.autoscaling_metric || "–",
          version: d.version,
        })), ["deployment", "replicas", "ongoing", "sessions",
              "autoscaling", "version"]);
    } else {
      document.getElementById("serve").innerHTML = "";
    }
    document.getElementById("nodes").innerHTML = rows(nodes.map(n => ({
      node: (n.node_id || "").slice(0, 12), state: n.state || "ALIVE",
      kind: n.kind || "", resources: JSON.stringify(n.resources || {}),
      // two-level scheduling: tasks sitting admitted in the node's
      // LocalScheduler right now / lifetime local admissions
      localq: n.local_queue_depth ?? 0,
      dispatched: n.local_dispatched ?? 0,
      // per-reason spillback ("reason:count ...") and resource-view
      // freshness (age of the head's last resview push to the daemon)
      spills: Object.entries(n.spill_reasons || {})
        .map(([r, c]) => r + ":" + c).join(" ") || "–",
      resview: n.resview_age_s == null ? "–"
        : n.resview_age_s.toFixed(1) + "s",
      // node-loss fault domain: why the reconciler declared it dead
      reason: n.death_reason || "–",
    })), ["node", "state", "kind", "resources", "localq", "dispatched",
          "spills", "resview", "reason"],
       ["state"]);
    document.getElementById("tasks").innerHTML = rows(
      Object.entries(t).map(([state, count]) => ({state, count})),
      ["state", "count"]);
    // trace rows link to the Perfetto export for that trace id; the
    // export link carries only the (hex, validated-by-slice) trace id
    document.getElementById("traces").innerHTML = rows(
      (traces || []).slice(0, 25).map(tr => ({
        trace: (tr.trace_id || "").slice(0, 16), root: tr.root || "",
        spans: tr.spans, live: tr.live_spans,
        failed: tr.failed || 0,
        duration: tr.first_ts && tr.last_ts ?
          fmtS(tr.last_ts - tr.first_ts) : "–",
        export: "", // filled below via DOM links
      })), ["trace", "root", "spans", "live", "failed", "duration",
            "export"]);
    // attach export links with DOM nodes (ids are escaped by esc()
    // already; the href is built from encodeURIComponent)
    document.querySelectorAll("#traces tbody tr").forEach((el, i) => {
      const tr = (traces || [])[i];
      if (!tr) return;
      const a = document.createElement("a");
      a.href = "/api/trace?trace_id=" +
        encodeURIComponent(tr.trace_id || "");
      a.textContent = "perfetto json";
      el.lastElementChild.replaceChildren(a);
    });
    document.getElementById("actors").innerHTML = rows(actors.slice(0, 50).map(a => ({
      actor: (a.actor_id || "").slice(0, 12), name: a.name || "",
      state: a.state || "", node: a.node_index ?? "",
      // peer route the p2p actor plane would ship calls to (blank for
      // head-local actors or when actor_p2p routing is unavailable)
      p2p: a.resolved_address ?
        (a.resolved_address.peer || []).join(":") +
          "#w" + a.resolved_address.worker_num : "",
    })), ["actor", "name", "state", "node", "p2p"], ["state"]);
    const streams = s.data_streams || [];
    document.getElementById("streams").innerHTML = rows(streams.map(d => ({
      stream: d.stream_id, dataset: d.dataset, consumers: d.consumers,
      epoch: d.epoch, produced: d.blocks_produced,
      consumed: d.blocks_consumed,
      overlap: (100 * (d.overlap_fraction || 0)).toFixed(0) + "%",
      state: d.live ? (d.producing ? "producing" : "idle") : "done",
    })), ["stream", "dataset", "consumers", "epoch", "produced",
          "consumed", "overlap", "state"]);
    drawChart();
  } catch (e) {
    document.getElementById("addr").textContent = "refresh failed: " + e;
  }
}
refresh();
setInterval(refresh, 2000);
</script>
</div></body></html>
"""


class Dashboard:
    def __init__(self, worker, port: int = 0):
        from ray_tpu_torch.util import state

        def api(fn):
            def call():
                return fn()

            return call

        def ring_totals() -> dict:
            """Control-ring counters summed over pools (the same
            numbers as the ray_tpu_control_ring_* metric families)."""
            ring = {"msgs": 0, "bytes": 0, "fallback": 0,
                    "full_waits": 0}
            for e in worker.gcs.node_table():
                rs = getattr(e.pool, "ring_stats", None)
                if rs:
                    for k in ring:
                        ring[k] += rs.get(k, 0)
            return ring

        def serve_snapshot() -> dict:
            """Serving-plane counters + per-deployment rows (the
            Serving panel source). sys.modules lookup, not an import:
            a dashboard poll must not drag the serve package in, and
            the panel stays empty-but-valid when serve never started."""
            import sys

            core = sys.modules.get("ray_tpu_torch.serve.core")
            if core is None:
                return {"deployments": []}
            return core.serving_stats()

        def flamegraph() -> dict:
            """Speedscope document over every resident folded stack —
            save the response and drop it on speedscope.app."""
            from ray_tpu_torch._private import profile_plane

            return profile_plane.speedscope(state.profile_stacks())

        routes = {
            "/api/tasks": lambda: state.list_tasks(),
            # live rows + the durable FINISHED/FAILED ring, with
            # per-transition timestamps (the task-detail table source)
            "/api/task_events": lambda: state.list_tasks(detail=True),
            "/api/timeline": lambda: state.task_timeline(),
            # trace plane: resident distributed traces, most recently
            # active first (the Traces panel source); empty when the
            # plane is disabled
            "/api/traces": lambda: state.list_traces(),
            "/api/actors": lambda: state.list_actors(),
            "/api/objects": lambda: state.list_objects(),
            "/api/nodes": lambda: state.list_nodes(),
            "/api/placement_groups":
                lambda: state.list_placement_groups(),
            # QoS plane: per-tenant fair-share/deficit rows (the
            # Tenants panel source); empty when qos=False
            "/api/tenants": lambda: state.list_tenants(),
            # serving plane: TTFT/affinity/shed counters + deployment
            # rows (the Serving panel source); empty when serve was
            # never started
            "/api/serve": serve_snapshot,
            "/api/data_streams": lambda: state.list_data_streams(),
            "/api/logs": lambda: state.list_logs(),
            # profile plane: per-node utilization series + folded
            # stacks (the Utilization panel source); empty when the
            # plane is disabled (profile_hz=0)
            "/api/utilization": lambda: state.list_utilization(),
            "/api/profile_stacks": lambda: state.profile_stacks(),
            "/api/flamegraph": flamegraph,
            "/api/jobs": lambda: {
                j.hex(): meta
                for j, meta in worker.gcs.job_table().items()},
            "/api/summary": lambda: {
                "tasks": state.summarize_tasks(),
                "scheduler": worker.scheduler.stats(),
                "control_ring": ring_totals(),
                "task_latency": (
                    worker.task_events.latency_summary()
                    if getattr(worker, "task_events", None) is not None
                    else None),
                "nodes": state.list_nodes(),
                "actors_alive": sum(
                    1 for a in state.list_actors()
                    if a["state"] == "ALIVE"),
                "data_streams": state.list_data_streams(),
                "time": time.time(),
            },
        }

        def log_file(query) -> dict:
            """/api/log_file?filename=...&node_id=...&tail=N — one
            capture file's lines as JSON (the UI sets them via
            textContent, so content never renders as markup)."""
            filename = (query.get("filename") or [""])[0]
            node_id = (query.get("node_id") or [""])[0] or None
            tail_q = (query.get("tail") or [""])[0]
            tail = int(tail_q) if tail_q else None
            text = state.get_log(filename, node_id=node_id, tail=tail)
            return {"filename": filename, "node_id": node_id,
                    "lines": text.split("\n")}

        def trace_export(query) -> list:
            """/api/trace?trace_id=... — one trace's Perfetto events
            (id prefix match; save the response and open it in
            ui.perfetto.dev)."""
            trace_id = (query.get("trace_id") or [""])[0]
            return state.get_trace(trace_id)

        query_routes = {
            "/api/log_file": log_file,
            "/api/trace": trace_export,
        }

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                from urllib.parse import parse_qs, urlsplit

                parts = urlsplit(self.path)
                path = parts.path
                if path == "/" or path == "/index.html":
                    self._send(200, _INDEX.encode(), "text/html")
                    return
                if path == "/metrics":
                    from ray_tpu_torch._private.metrics import render_all

                    self._send(200, render_all(worker).encode(),
                               "text/plain; version=0.0.4")
                    return
                qfn = query_routes.get(path)
                fn = routes.get(path)
                if qfn is None and fn is None:
                    self._send(404, b'{"error": "not found"}')
                    return
                try:
                    data = (qfn(parse_qs(parts.query))
                            if qfn is not None else fn())
                    self._send(200, json.dumps(data).encode())
                except Exception as e:  # noqa: BLE001
                    self._send(500,
                               json.dumps({"error": str(e)}).encode())

            def _send(self, code, body,
                      ctype="application/json") -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self._httpd = http.server.ThreadingHTTPServer(
            ("127.0.0.1", port), Handler)
        self.port = self._httpd.server_port
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="ray_tpu_dashboard")
        self._thread.start()

    def shutdown(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:
            pass


_dashboard: Optional[Dashboard] = None


def start_dashboard(port: int = 0) -> int:
    """Start (or return) the dashboard; returns the bound port."""
    global _dashboard
    from ray_tpu_torch._private import worker as worker_mod

    if _dashboard is None:
        _dashboard = Dashboard(worker_mod.get_worker(), port)
    return _dashboard.port


def stop_dashboard() -> None:
    global _dashboard
    if _dashboard is not None:
        _dashboard.shutdown()
        _dashboard = None
