"""The live ops dashboard served at ``GET /dashboard``.

The JAX package's page, copied as it stands (``tests/test_torch_serve_
dashboard.py`` holds the two equal byte for byte): one self-contained
page, no external assets, whose tiles and tables poll ``/debug/slo``,
``/healthz``, ``/debug/history``, ``/debug/incidents``,
``/debug/traces?limit=10``, ``/debug/fit`` and ``/debug/fleet`` every
2 s. The last two are not served by the port yet; the page fetches each
inside a ``try`` and leaves its tiles empty on a 404. Status colors are
the reserved status palette and always ship with an icon and a label
(never color alone); light and dark themes are both selected through
custom properties.
"""

DASHBOARD_HTML = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>spark_rapids_ml_tpu · serving ops</title>
<style>
  .viz-root {
    color-scheme: light;
    --surface-1: #fcfcfb;
    --surface-2: #f0efec;
    --text-primary: #0b0b0b;
    --text-secondary: #52514e;
    --status-good: #0ca30c;
    --status-warning: #fab219;
    --status-serious: #ec835a;
    --status-critical: #d03b3b;
    --border: #d9d8d4;
    --series-1: #2a78d6;
  }
  @media (prefers-color-scheme: dark) {
    :root:where(:not([data-theme="light"])) .viz-root {
      color-scheme: dark;
      --surface-1: #1a1a19;
      --surface-2: #383835;
      --text-primary: #ffffff;
      --text-secondary: #c3c2b7;
      --border: #44443f;
      --series-1: #3987e5;
    }
  }
  :root[data-theme="dark"] .viz-root {
    color-scheme: dark;
    --surface-1: #1a1a19;
    --surface-2: #383835;
    --text-primary: #ffffff;
    --text-secondary: #c3c2b7;
    --border: #44443f;
    --series-1: #3987e5;
  }
  body { margin: 0; }
  .viz-root {
    font: 14px/1.45 system-ui, -apple-system, "Segoe UI", sans-serif;
    background: var(--surface-1); color: var(--text-primary);
    min-height: 100vh; padding: 20px 24px; box-sizing: border-box;
  }
  h1 { font-size: 17px; font-weight: 600; margin: 0 0 2px; }
  h2 { font-size: 13px; font-weight: 600; margin: 22px 0 8px;
       color: var(--text-secondary); text-transform: uppercase;
       letter-spacing: 0.04em; }
  .sub { color: var(--text-secondary); margin: 0 0 18px; }
  .tiles { display: flex; flex-wrap: wrap; gap: 12px; }
  .tile { background: var(--surface-2); border-radius: 8px;
          padding: 12px 16px; min-width: 150px; }
  .tile .label { color: var(--text-secondary); font-size: 12px; }
  .tile .value { font-size: 26px; font-weight: 600; margin-top: 2px; }
  table { border-collapse: collapse; width: 100%; }
  th { text-align: left; color: var(--text-secondary); font-weight: 500;
       font-size: 12px; border-bottom: 1px solid var(--border);
       padding: 4px 10px 4px 0; }
  td { padding: 5px 10px 5px 0; border-bottom: 1px solid var(--border);
       font-variant-numeric: tabular-nums; }
  td.name { font-variant-numeric: normal; }
  .status { display: inline-flex; align-items: center; gap: 6px; }
  .dot { width: 9px; height: 9px; border-radius: 50%; display: inline-block; }
  .good .dot { background: var(--status-good); }
  .warning .dot { background: var(--status-warning); }
  .serious .dot { background: var(--status-serious); }
  .critical .dot { background: var(--status-critical); }
  .mono { font-family: ui-monospace, monospace; font-size: 12px; }
  details { margin: 4px 0; }
  summary { cursor: pointer; color: var(--text-secondary); }
  pre { background: var(--surface-2); border-radius: 6px; padding: 10px;
        overflow-x: auto; font-size: 11px; }
  .quiet { color: var(--text-secondary); }
  svg.spark { display: block; margin-top: 6px; overflow: visible; }
  svg.spark polyline { stroke: var(--series-1); fill: none;
       stroke-width: 2; stroke-linejoin: round; stroke-linecap: round; }
  svg.spark circle { fill: var(--series-1); }
  #tip { position: fixed; display: none; pointer-events: none;
       background: var(--surface-2); color: var(--text-primary);
       border: 1px solid var(--border); border-radius: 4px;
       padding: 2px 7px; font-size: 11px; z-index: 10;
       font-variant-numeric: tabular-nums; }
</style>
</head>
<body>
<div class="viz-root">
  <h1>Serving ops</h1>
  <p class="sub">live view over <span class="mono">/debug/slo</span>,
    <span class="mono">/debug/history</span>,
    <span class="mono">/debug/incidents</span>,
    <span class="mono">/debug/traces</span>, and
    <span class="mono">/healthz</span> · refreshes every 2&thinsp;s</p>
  <div class="tiles" id="tiles"></div>
  <h2>Metrics history · last 5 min</h2>
  <div class="tiles" id="history">—</div>
  <div id="tip"></div>
  <h2>SLO burn rates</h2>
  <table><thead><tr><th>Objective</th><th>Target</th><th>5m</th><th>30m</th>
    <th>1h</th><th>6h</th><th>Budget left</th><th>State</th></tr></thead>
    <tbody id="slo-rows"></tbody></table>
  <h2>Fleet</h2>
  <div id="fleet" class="quiet">—</div>
  <h2>Serving replicas</h2>
  <div id="replicas" class="quiet">—</div>
  <h2>Fit runs</h2>
  <div id="fit" class="quiet">—</div>
  <h2>Incidents</h2>
  <div id="incidents" class="quiet">—</div>
  <h2>Circuit breakers</h2>
  <div id="breakers" class="quiet">—</div>
  <h2>Firing alerts</h2>
  <div id="alerts" class="quiet">—</div>
  <h2>Recent traces</h2>
  <div id="traces" class="quiet">—</div>
</div>
<script>
function fmtPct(v) {
  return (v == null) ? "–" : (100 * v).toFixed(2) + "%";
}
function fmtBurn(v) {
  return (v == null) ? "–" : v.toFixed(2);
}
function fmtBytes(v) {
  if (v == null) return "–";
  var units = ["B", "KiB", "MiB", "GiB", "TiB"], i = 0;
  while (v >= 1024 && i < units.length - 1) { v /= 1024; i += 1; }
  return v.toFixed(v >= 10 || i === 0 ? 0 : 1) + " " + units[i];
}
function stateFor(slo) {
  if (slo.alerts.some(a => a.severity === "page_fast"))
    return ["critical", "\\u25cf paging (fast)"];
  if (slo.alerts.length) return ["serious", "\\u25cf paging (slow)"];
  var rates = Object.values(slo.burn_rates || {});
  if (rates.some(r => r > 1)) return ["warning", "\\u25cf burning budget"];
  return ["good", "\\u25cf within budget"];
}
function tile(label, value, trend) {
  return '<div class="tile"><div class="label">' + label +
    '</div><div class="value">' + value + "</div>" + (trend || "") +
    "</div>";
}
function fmtVal(v) {
  if (v == null || !isFinite(v)) return "\\u2013";
  var a = Math.abs(v);
  if (a >= 1e9) return (v / 1e9).toFixed(1) + "G";
  if (a >= 1e6) return (v / 1e6).toFixed(1) + "M";
  if (a >= 1e3) return (v / 1e3).toFixed(1) + "K";
  if (a >= 100) return v.toFixed(0);
  if (a >= 1) return v.toFixed(2);
  if (a === 0) return "0";
  return v.toPrecision(3);
}
var SPARK_W = 150, SPARK_H = 36;
function sparkSvg(points) {
  // one series per sparkline (the tile label names it — no legend);
  // 2px line in --series-1, last point dotted, values live in #tip
  if (!points || points.length < 2)
    return '<div class="spark quiet" style="height:' + SPARK_H +
      'px;font-size:11px;margin-top:6px">collecting\\u2026</div>';
  var t0 = points[0][0], t1 = points[points.length - 1][0];
  var vs = points.map(function (p) { return p[1]; });
  var lo = Math.min.apply(null, vs), hi = Math.max.apply(null, vs);
  if (hi === lo) hi = lo + 1;
  var pad = 3;
  function xy(p) {
    var x = pad + (SPARK_W - 2 * pad) *
      (t1 === t0 ? 1 : (p[0] - t0) / (t1 - t0));
    var y = pad + (SPARK_H - 2 * pad) * (1 - (p[1] - lo) / (hi - lo));
    return [x, y];
  }
  var line = points.map(function (p) {
    var c = xy(p);
    return c[0].toFixed(1) + "," + c[1].toFixed(1);
  }).join(" ");
  var last = xy(points[points.length - 1]);
  return '<svg class="spark" width="' + SPARK_W + '" height="' +
    SPARK_H + '" data-points=\\'' + JSON.stringify(points) +
    '\\' role="img"><polyline points="' + line + '"/><circle cx="' +
    last[0].toFixed(1) + '" cy="' + last[1].toFixed(1) +
    '" r="2.5"/></svg>';
}
function seriesLabel(prefix, labels) {
  var parts = [];
  ["model", "device", "component", "arm", "outcome", "host",
   "horizon"].forEach(
    function (k) {
      if (labels && labels[k]) parts.push(labels[k]);
    });
  return prefix + (parts.length ? " \\u00b7 " + parts.join(" / ") : "");
}
function trendTile(prefix, series, fmt) {
  var pts = series.points || [];
  var cur = pts.length ? pts[pts.length - 1][1] : null;
  return tile(seriesLabel(prefix, series.labels),
              (fmt || fmtVal)(cur), sparkSvg(pts));
}
function historyTiles(hist) {
  var key = (hist && hist.key) || {};
  var tiles = [];
  (key.queue_depth || []).forEach(function (s) {
    tiles.push(trendTile("queue depth", s));
  });
  (key.p99_latency_seconds || []).forEach(function (s) {
    tiles.push(trendTile("p99 latency", s, function (v) {
      return v == null ? "\\u2013" : (1000 * v).toFixed(1) + " ms";
    }));
  });
  (key.request_rate || []).forEach(function (s) {
    if (s.labels && s.labels.outcome && s.labels.outcome !== "ok")
      return;  // error outcomes live in the SLO table
    tiles.push(trendTile("req/s", s, function (v) {
      return v == null ? "\\u2013" : fmtVal(v) + "/s";
    }));
  });
  (key.device_mem_bytes_in_use || []).forEach(function (s) {
    tiles.push(trendTile("mem in use", s, function (v) {
      return v == null ? "\\u2013" : fmtVal(v) + "B";
    }));
  });
  (key.device_busy_rate || []).forEach(function (s) {
    tiles.push(trendTile("device busy", s, function (v) {
      return v == null ? "\\u2013" : (100 * v).toFixed(1) + "%";
    }));
  });
  (key.obs_overhead_rate || []).forEach(function (s) {
    tiles.push(trendTile("obs overhead", s, function (v) {
      return v == null ? "\\u2013" : (100 * v).toFixed(2) + "%";
    }));
  });
  // the per-model cost ledger (/debug/costs): residency by component,
  // attributed device time, traffic temperature
  (key.model_hbm_bytes || []).forEach(function (s) {
    tiles.push(trendTile("model HBM", s, function (v) {
      return v == null ? "\\u2013" : fmtVal(v) + "B";
    }));
  });
  (key.model_device_rate || []).forEach(function (s) {
    tiles.push(trendTile("model device", s, function (v) {
      return v == null ? "\\u2013" : (100 * v).toFixed(1) + "%";
    }));
  });
  (key.model_ewma_rps || []).forEach(function (s) {
    tiles.push(trendTile("model rows/s", s, function (v) {
      return v == null ? "\\u2013" : fmtVal(v) + "/s";
    }));
  });
  // canary per-arm sparklines (candidate vs incumbent)
  (key.canary_arm_p99_seconds || []).forEach(function (s) {
    tiles.push(trendTile("canary p99", s, function (v) {
      return v == null ? "\\u2013" : (1000 * v).toFixed(1) + " ms";
    }));
  });
  (key.canary_arm_error_rate || []).forEach(function (s) {
    tiles.push(trendTile("canary err", s, function (v) {
      return v == null ? "\\u2013" : (100 * v).toFixed(2) + "%";
    }));
  });
  // fleet liveness + the forecaster's predictive signals
  (key.fleet_host_up || []).forEach(function (s) {
    tiles.push(trendTile("host up", s));
  });
  (key.forecast_queue_wait_ms || []).forEach(function (s) {
    tiles.push(trendTile("fc queue wait", s, function (v) {
      return v == null ? "\\u2013" : fmtVal(v) + " ms";
    }));
  });
  (key.forecast_rps || []).forEach(function (s) {
    tiles.push(trendTile("fc req/s", s, function (v) {
      return v == null ? "\\u2013" : fmtVal(v) + "/s";
    }));
  });
  return tiles;
}
document.addEventListener("mousemove", function (e) {
  var tip = document.getElementById("tip");
  var svg = e.target && e.target.closest
    ? e.target.closest("svg.spark") : null;
  if (!svg) { if (tip) tip.style.display = "none"; return; }
  var points = [];
  try { points = JSON.parse(svg.getAttribute("data-points")); }
  catch (err) { return; }
  if (!points.length) return;
  var rect = svg.getBoundingClientRect();
  var frac = Math.min(Math.max(
    (e.clientX - rect.left) / rect.width, 0), 1);
  var idx = Math.round(frac * (points.length - 1));
  var p = points[idx];
  var ago = Math.max(0, Date.now() / 1000 - p[0]);
  tip.textContent = fmtVal(p[1]) + " \\u00b7 " +
    (ago < 120 ? ago.toFixed(0) + " s ago"
               : (ago / 60).toFixed(1) + " min ago");
  tip.style.left = (e.clientX + 12) + "px";
  tip.style.top = (e.clientY + 12) + "px";
  tip.style.display = "block";
});
function statusSpan(cls, text) {
  return '<span class="status ' + cls + '"><span class="dot"></span>' +
    text.replace("\\u25cf ", "") + "</span>";
}
function fmtAgo(ts) {
  if (ts == null) return "\\u2013";
  var ago = Math.max(0, Date.now() / 1000 - ts);
  if (ago < 120) return ago.toFixed(0) + " s ago";
  if (ago < 7200) return (ago / 60).toFixed(1) + " min ago";
  return (ago / 3600).toFixed(1) + " h ago";
}
function severityClass(sev) {
  if (sev === "critical") return "critical";
  if (sev === "serious") return "serious";
  return "warning";
}
function incidentRows(list, state) {
  return list.map(function (inc) {
    var labels = Object.keys(inc.labels || {}).map(function (k) {
      return k + "=" + inc.labels[k];
    }).join(" ");
    return "<tr><td class=name>" + inc.detector +
      (labels ? " \\u00b7 " + labels : "") + "</td><td>" +
      statusSpan(state === "open" ? severityClass(inc.severity)
                                  : "good",
                 "\\u25cf " + inc.severity +
                 (state === "open" ? "" : " (resolved)")) +
      "</td><td>" + fmtAgo(inc.opened_ts) + "</td><td>" +
      (inc.duration_seconds == null ? "\\u2013"
        : inc.duration_seconds.toFixed(0) + " s") +
      "</td><td>" + fmtVal(inc.value) + " vs " +
      fmtVal(inc.baseline) + "</td><td class=name><span class=mono>" +
      ((inc.evidence || {}).dir || "\\u2013") + "</span></td></tr>";
  }).join("");
}
function sumSeries(seriesList) {
  // point-wise sum across children keyed by sample timestamp (every
  // child shares the sampler's sweep timestamps) — the engine-wide
  // overview tile must trend the SUM, not whichever model's series
  // happened to come back first
  var byTs = {};
  seriesList.forEach(function (s) {
    (s.points || []).forEach(function (p) {
      byTs[p[0]] = (byTs[p[0]] || 0) + p[1];
    });
  });
  return Object.keys(byTs).map(function (t) { return parseFloat(t); })
    .sort(function (a, b) { return a - b; })
    .map(function (t) { return [t, byTs[t]]; });
}
async function refresh() {
  try {
    var slo = await (await fetch("/debug/slo")).json();
    var health = await (await fetch("/healthz")).json();
    var hist = {};
    try { hist = await (await fetch("/debug/history")).json(); }
    catch (err) { hist = {}; }
    var inc = {};
    try { inc = await (await fetch("/debug/incidents")).json(); }
    catch (err) { inc = {}; }
    var fit = {};
    try { fit = await (await fetch("/debug/fit")).json(); }
    catch (err) { fit = {}; }
    var incOpen = inc.open || [], incRecent = inc.recent || [];
    var qdSeries = ((hist.key || {}).queue_depth || []);
    var qdPoints = qdSeries.length ? sumSeries(qdSeries) : null;
    var breakers = slo.breakers || {};
    var breakerNames = Object.keys(breakers);
    var openCount = breakerNames.filter(
      function (n) { return breakers[n].state !== "closed"; }).length;
    var tiles = [
      tile("Service", statusSpan(
        health.status === "ok" ? "good" : "warning", health.status)),
      tile("Shed level", health.shed_level
        ? statusSpan("serious", "\\u25cf " + health.shed_level)
        : statusSpan("good", "\\u25cf 0")),
      tile("Queue depth", health.queue_depth,
           qdPoints ? sparkSvg(qdPoints) : ""),
      tile("In flight", (health.inflight || []).length),
      tile("Firing alerts", (slo.alerts || []).length),
      tile("Breakers open", openCount
        ? statusSpan("critical", "\\u25cf " + openCount)
        : statusSpan("good", "\\u25cf 0")),
      tile("Open incidents", incOpen.length
        ? statusSpan(severityClass(incOpen[0].severity),
                     "\\u25cf " + incOpen.length)
        : statusSpan("good", "\\u25cf 0")),
      tile("Degraded served", slo.degraded_total || 0),
      tile("Retries", slo.retries_total || 0),
      tile("Worker restarts", slo.worker_restarts_total || 0),
    ];
    var autoscale = slo.autoscale || {};
    if (autoscale.enabled) {
      tiles.push(tile(
        "Autoscale replicas",
        autoscale.replicas + " / [" + autoscale.min + "\\u2013"
          + autoscale.max + "]"
          + (autoscale.running ? "" : " (stopped)")));
    }
    var tiering = slo.tiering || {};
    if (tiering.enabled) {
      var tc = tiering.state_counts || {};
      tiles.push(tile(
        "Model tiers",
        (tc.active || 0) + " hot / " + (tc.cold || 0) + " cold"
          + (tiering.hbm_budget_bytes
             ? " \\u00b7 " + fmtBytes(tiering.resident_bytes || 0)
               + " of " + fmtBytes(tiering.hbm_budget_bytes)
             : "")
          + (tiering.running ? "" : " (stopped)")));
    }
    var wd = fit.watchdog || null;
    if (wd && wd.checked_unix != null) {
      tiles.push(tile("Fit backend", wd.ok
        ? statusSpan("good", "\\u25cf " + (wd.platform || "ok"))
        : statusSpan("critical", "\\u25cf " + (wd.reason || "degraded"))));
    }
    if ((fit.active || []).length) {
      tiles.push(tile("Active fits", fit.active.length));
    }
    (slo.slos || []).forEach(function (s) {
      tiles.push(tile("Budget left · " + s.name,
                      fmtPct(s.budget_remaining)));
    });
    document.getElementById("tiles").innerHTML = tiles.join("");
    var htiles = historyTiles(hist);
    document.getElementById("history").innerHTML = htiles.length
      ? htiles.join("")
      : '<span class="quiet">no history yet \\u2014 the sampler ' +
        'populates this within a few seconds</span>';
    document.getElementById("slo-rows").innerHTML =
      (slo.slos || []).map(function (s) {
        var st = stateFor(s);
        var b = s.burn_rates || {};
        return "<tr><td class=name>" + s.objective + "</td><td>" +
          s.target + "</td><td>" + fmtBurn(b["5m"]) + "</td><td>" +
          fmtBurn(b["30m"]) + "</td><td>" + fmtBurn(b["1h"]) +
          "</td><td>" + fmtBurn(b["6h"]) + "</td><td>" +
          fmtPct(s.budget_remaining) + "</td><td>" +
          statusSpan(st[0], st[1]) + "</td></tr>";
      }).join("");
    var replicaSets = slo.replicas || {};
    var replicaModels = Object.keys(replicaSets);
    document.getElementById("replicas").innerHTML = replicaModels.length
      ? replicaModels.map(function (m) {
          var doc = replicaSets[m];
          var tiles = (doc.replicas || []).map(function (r) {
            var cls = r.state === "serving" ? "good"
              : (r.state === "draining" ? "warning" : "critical");
            return tile(m + " \\u00b7 " + r.device,
              statusSpan(cls, "\\u25cf " + r.state) +
              '<div class="label" style="margin-top:4px">queue ' +
              r.queue_depth + " \\u00b7 load " + r.load +
              (r.consecutive_failures
                ? " \\u00b7 fails " + r.consecutive_failures : "") +
              "</div>");
          });
          return '<div class="tiles" style="margin-bottom:10px">' +
            tiles.join("") + "</div>";
        }).join("")
      : "no models served yet";
    var fitRuns = (fit.active || []).concat(fit.recent || []);
    document.getElementById("fit").innerHTML = fitRuns.length
      ? "<table><thead><tr><th>Run</th><th>Algo</th><th>Status</th>" +
        "<th>Steps</th><th>Rows/s</th><th>Device s</th><th>MFU</th>" +
        "<th>Stragglers</th></tr></thead><tbody>" +
        fitRuns.map(function (r) {
          var mfu = r.mfu_mean == null ? "\\u2013"
            : (100 * r.mfu_mean).toFixed(1) + "%";
          var strag = (r.stragglers || []).join(" ") || "\\u2013";
          return "<tr><td class=mono>" + r.run_id + "</td>" +
            "<td class=name>" + r.algo + "</td><td>" +
            statusSpan(r.status === "running" ? "warning" : "good",
                       "\\u25cf " + r.status) + "</td><td>" + r.steps +
            (r.steps_failed ? " (" + r.steps_failed + " failed)" : "") +
            "</td><td>" + fmtVal(r.rows_per_sec) + "</td><td>" +
            fmtVal(r.device_seconds) + "</td><td>" + mfu + "</td>" +
            "<td class=name>" + strag + "</td></tr>";
        }).join("") + "</tbody></table>"
      : "no fit runs yet \\u2014 distributed fits and the streaming " +
        "trainer report here";
    document.getElementById("incidents").innerHTML =
      (incOpen.length || incRecent.length)
        ? "<table><thead><tr><th>Detector</th><th>Severity</th>" +
          "<th>Opened</th><th>Duration</th><th>Value vs baseline</th>" +
          "<th>Evidence bundle</th></tr></thead><tbody>" +
          incidentRows(incOpen, "open") +
          incidentRows(incRecent, "resolved") + "</tbody></table>"
        : "no incidents \\u2014 " + (inc.opened_total || 0) +
          " opened / " + (inc.resolved_total || 0) +
          " resolved since start";
    document.getElementById("breakers").innerHTML = breakerNames.length
      ? "<table><thead><tr><th>Model</th><th>State</th>" +
        "<th>Consecutive failures</th><th>Opens</th><th>Open for</th>" +
        "<th>Last error</th></tr></thead><tbody>" +
        breakerNames.map(function (n) {
          var b = breakers[n];
          var cls = b.state === "closed" ? "good"
            : (b.state === "half_open" ? "warning" : "critical");
          return "<tr><td class=name>" + n + "</td><td>" +
            statusSpan(cls, "\\u25cf " + b.state) + "</td><td>" +
            b.consecutive_failures + " / " + b.failure_threshold +
            "</td><td>" + b.opens + "</td><td>" +
            (b.open_for_seconds == null ? "–"
              : b.open_for_seconds.toFixed(1) + " s") +
            "</td><td class=name>" + (b.last_error || "–") +
            "</td></tr>";
        }).join("") + "</tbody></table>"
      : "no models served yet";
    var alerts = slo.alerts || [];
    document.getElementById("alerts").innerHTML = alerts.length
      ? "<table><thead><tr><th>SLO</th><th>Severity</th><th>Short</th>" +
        "<th>Long</th><th>Factor</th></tr></thead><tbody>" +
        alerts.map(function (a) {
          return "<tr><td class=name>" + a.slo + "</td><td>" +
            statusSpan(a.severity === "page_fast" ? "critical" : "serious",
                       a.severity) + "</td><td>" +
            a.short_window + " @ " + fmtBurn(a.short_burn_rate) +
            "</td><td>" + a.long_window + " @ " +
            fmtBurn(a.long_burn_rate) + "</td><td>" + a.factor +
            "</td></tr>";
        }).join("") + "</tbody></table>"
      : "no alerts firing";
    var fleet = {};
    try { fleet = await (await fetch("/debug/fleet")).json(); }
    catch (err) { fleet = {}; }
    var rollup = fleet.rollup || null;
    var fc = (rollup && rollup.forecast) || fleet.forecast || null;
    var fleetTiles = [];
    if (rollup) {
      fleetTiles.push(tile("Hosts up",
        statusSpan(rollup.hosts_up === rollup.hosts_total
                     ? "good" : "critical",
                   "\\u25cf " + rollup.hosts_up + " / " +
                     rollup.hosts_total)));
      (rollup.hosts || []).forEach(function (h) {
        fleetTiles.push(tile(h.host,
          statusSpan(h.up ? "good" : "critical",
                     "\\u25cf " + (h.up ? "up" : "down")) +
          '<div class="label" style="margin-top:4px">' +
          (h.staleness_seconds == null ? "never polled"
            : "stale " + h.staleness_seconds.toFixed(1) + " s") +
          (h.replicas != null ? " \\u00b7 " + h.replicas + " repl"
                              : "") +
          (h.open_incidents ? " \\u00b7 " + h.open_incidents + " inc"
                            : "") + "</div>"));
      });
      var finc = rollup.fleet_incidents || [];
      fleetTiles.push(tile("Fleet incidents", finc.length
        ? statusSpan("critical", "\\u25cf " + finc.length)
        : statusSpan("good", "\\u25cf 0")));
      if (rollup.slo_burn && rollup.slo_burn.max != null) {
        fleetTiles.push(tile("Fleet burn (5m max)",
                             fmtBurn(rollup.slo_burn.max)));
      }
    }
    if (fc && fc.signals) {
      Object.keys(fc.signals).forEach(function (sig) {
        var doc = fc.signals[sig] || {};
        var projections = doc.projections || {};
        var parts = Object.keys(projections).map(function (h) {
          return h + ": " + fmtVal(projections[h]);
        });
        var backtest = (doc.backtest || {});
        fleetTiles.push(tile("forecast \\u00b7 " + sig,
          (parts.join(" \\u00b7 ") || "\\u2013") +
          '<div class="label" style="margin-top:4px">backtest ' +
          (backtest.abs_err_mean == null ? "\\u2013"
            : "|err| " + fmtVal(backtest.abs_err_mean)) + "</div>"));
      });
    }
    document.getElementById("fleet").innerHTML = fleetTiles.length
      ? '<div class="tiles">' + fleetTiles.join("") + "</div>"
      : "not aggregating \\u2014 attach a FleetAggregator " +
        "(obs.federation) to federate peers into this process";
    var tr = await (await fetch("/debug/traces?limit=10")).json();
    var traces = tr.traces || [];
    document.getElementById("traces").innerHTML = traces.length
      ? traces.map(function (t) {
          var root = (t.spans && t.spans[0]) || {};
          return "<details><summary><span class=mono>" + t.trace_id +
            "</span> · " + (root.name || "?") + " · " + t.span_count +
            " spans · " + (root.duration_ms || 0).toFixed(2) +
            " ms</summary><pre>" +
            JSON.stringify(t, null, 1) + "</pre></details>";
        }).join("")
      : "no traces yet";
  } catch (err) {
    document.getElementById("alerts").textContent =
      "refresh failed: " + err;
  }
}
refresh();
setInterval(refresh, 2000);
</script>
</body>
</html>
"""


__all__ = ["DASHBOARD_HTML"]
