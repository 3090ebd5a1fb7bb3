"""The dashboard (port of ray_tpu/dashboard/dashboard.py): an HTTP
endpoint over a running head's tables, on a threaded stdlib server.

  GET /                   an auto-refreshing HTML overview
  GET /api/cluster        the ``rt status``-shaped summary (util/state.py)
  GET /api/nodes          the node table
  GET /api/actors         the actor table
  GET /api/tasks          the task records
  GET /api/pgs            the placement groups
  GET /api/jobs           the submitted jobs (job/job_manager.py)
  GET /api/objects        the object store's figures
  GET /api/stacks[/<p>]   live stacks of the workers whose id starts with p
  GET /metrics            the Prometheus text exposition (util/metrics.py)

The routes and their JSON are ray_tpu's; the page counts the card as
``"GPU"``, where ray_tpu's counts ``"TPU"`` chips.

    from ray_tpu_torch.dashboard import start_dashboard
    dash = start_dashboard(port=8265)   # 0: an ephemeral port
    dash.url
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_PAGE = """<!doctype html>
<html><head><title>ray_tpu_torch dashboard</title><meta charset="utf-8">
<style>
 :root{--bg:#fafafa;--fg:#222;--mut:#667;--line:#ddd;--card:#fff;--ok:#107a3d;--bad:#b3261e;--bar:#3b6fd4}
 @media (prefers-color-scheme: dark){:root{--bg:#16181d;--fg:#e6e6e6;--mut:#9aa;--line:#333;--card:#1e2128;--bar:#6c9bf2}}
 body{font-family:system-ui,sans-serif;margin:1.5rem;background:var(--bg);color:var(--fg)}
 h1{font-size:1.25rem;margin:0 0 .75rem}
 .cards{display:flex;gap:.75rem;flex-wrap:wrap;margin-bottom:1rem}
 .card{background:var(--card);border:1px solid var(--line);border-radius:8px;padding:.6rem .9rem;min-width:8rem}
 .card b{display:block;font-size:1.25rem} .card span{color:var(--mut);font-size:.75rem}
 nav{display:flex;gap:.25rem;border-bottom:1px solid var(--line);margin-bottom:.75rem}
 nav a{padding:.4rem .8rem;cursor:pointer;color:var(--mut);border-bottom:2px solid transparent;font-size:.9rem}
 nav a.on{color:var(--fg);border-color:var(--bar)}
 section{display:none} section.on{display:block}
 table{border-collapse:collapse;width:100%;background:var(--card)} td,th{border:1px solid var(--line);padding:.3rem .6rem;font-size:.82rem;text-align:left}
 th{color:var(--mut);font-weight:600}
 .bar{background:var(--line);border-radius:4px;height:8px;width:120px;display:inline-block;vertical-align:middle}
 .bar i{display:block;height:8px;border-radius:4px;background:var(--bar)}
 .ok{color:var(--ok)} .bad{color:var(--bad)}
 svg{vertical-align:middle}
 pre{background:var(--card);border:1px solid var(--line);padding:.6rem;font-size:.75rem;overflow:auto;max-height:24rem}
 button{background:var(--card);border:1px solid var(--line);color:var(--fg);border-radius:5px;padding:.2rem .6rem;cursor:pointer;font-size:.8rem}
</style></head>
<body>
<h1>ray_tpu_torch dashboard</h1>
<div class="cards" id="cards"></div>
<nav id="tabs"></nav>
<section id="t-nodes"><table id="nodes"></table></section>
<section id="t-actors"><table id="actors"></table></section>
<section id="t-tasks"><div id="tasks-summary"></div><h3>throughput (finished/s)</h3><svg id="spark" width="560" height="70"></svg></section>
<section id="t-pgs"><table id="pgs"></table></section>
<section id="t-jobs"><table id="jobs"></table></section>
<section id="t-objects"><div id="objects"></div></section>
<section id="t-stacks"><button onclick="loadStacks()">capture live stacks</button><div id="stacks"></div></section>
<script>
const TABS=[["nodes","Nodes"],["actors","Actors"],["tasks","Tasks"],["pgs","Placement groups"],["jobs","Jobs"],["objects","Objects"],["stacks","Stacks"]];
let cur="nodes";
function renderTabs(){document.getElementById("tabs").innerHTML=TABS.map(([id,label])=>
  `<a class="${id===cur?"on":""}" onclick="show('${id}')">${label}</a>`).join("");
  TABS.forEach(([id])=>document.getElementById("t-"+id).className=id===cur?"on":"")}
function show(id){cur=id;renderTabs()}
async function j(p){const r=await fetch(p);return r.json()}
function esc(v){const d=document.createElement("div");d.textContent=String(v);return d.innerHTML}
function row(cells,tag){return "<tr>"+cells.map(c=>`<${tag}>${c}</${tag}>`).join("")+"</tr>"}
function fill(id,header,rows){document.getElementById(id).innerHTML=
  row(header.map(esc),"th")+rows.map(r=>row(r,"td")).join("")}
function bar(used,total){const pct=total>0?Math.min(100,100*used/total):0;
  return `<span class="bar"><i style="width:${pct.toFixed(0)}%"></i></span> ${used.toFixed(1)}/${total.toFixed(1)}`}
const hist=[];let lastFinished=null,lastT=null;
function spark(){const svg=document.getElementById("spark");if(!hist.length){svg.innerHTML="";return}
  const w=560,h=70,max=Math.max(...hist,1);const pts=hist.map((v,i)=>
    `${(i/(Math.max(hist.length-1,1))*w).toFixed(1)},${(h-4-(v/max)*(h-10)).toFixed(1)}`).join(" ");
  svg.innerHTML=`<polyline fill="none" stroke="var(--bar)" stroke-width="2" points="${pts}"/>
    <text x="4" y="12" fill="var(--mut)" font-size="10">peak ${max.toFixed(1)}/s</text>`}
async function refresh(){
  const [c,tl,a,pgs,jobs,o]=await Promise.all([
    j("/api/cluster"),j("/api/tasks"),j("/api/actors"),j("/api/pgs"),j("/api/jobs"),j("/api/objects")]);
  const res=c.cluster_resources||{},avail=c.available_resources||{};
  const cpuT=res.CPU||0,cpuA=avail.CPU||0,gpuT=res.GPU||0,gpuA=avail.GPU||0;
  const t={}; for(const x of (Array.isArray(tl)?tl:[])){t[x.status]=(t[x.status]||0)+1}
  // throughput from LIFETIME totals (the record list is windowed/pruned)
  const finished=(c.task_counts||{}).finished??(t.FINISHED||0);
  const running=t.RUNNING||0,pending=(t.PENDING||0)+(t.QUEUED||0)+(t.WAITING||0);
  const now=Date.now()/1000;
  if(lastFinished!==null&&now>lastT){hist.push(Math.max(0,(finished-lastFinished)/(now-lastT)));if(hist.length>120)hist.shift()}
  lastFinished=finished;lastT=now;
  document.getElementById("cards").innerHTML=
    `<div class="card"><b>${c.nodes.length}</b><span>nodes</span></div>`+
    `<div class="card"><b>${running}</b><span>tasks running</span></div>`+
    `<div class="card"><b>${pending}</b><span>tasks pending</span></div>`+
    `<div class="card"><b>${bar(cpuT-cpuA,cpuT)}</b><span>CPU in use</span></div>`+
    (gpuT?`<div class="card"><b>${bar(gpuT-gpuA,gpuT)}</b><span>GPUs in use</span></div>`:"")+
    `<div class="card"><b>${c.pending_demand.length}</b><span>pending demand</span></div>`;
  fill("nodes",["node","alive","workers","CPU","GPU","labels"],
    c.nodes.map(n=>[esc(n.node_id.slice(0,12)),
      n.alive?'<span class="ok">alive</span>':'<span class="bad">dead</span>',
      esc(n.num_workers),
      bar((n.resources.CPU||0)-(n.available.CPU||0),n.resources.CPU||0),
      n.resources.GPU?bar((n.resources.GPU||0)-(n.available.GPU||0),n.resources.GPU):"",
      esc(JSON.stringify(n.labels||{}))]));
  fill("actors",["actor","name","state","class","node","restarts"],
    a.map(x=>[esc(x.actor_id.slice(0,12)),esc(x.name||""),
      x.state==="ALIVE"?'<span class="ok">ALIVE</span>':esc(x.state),
      esc(x["class"]),esc((x.node_id||"").slice(0,12)),esc(x.num_restarts)]));
  document.getElementById("tasks-summary").innerHTML=
    Object.entries(t).map(([k,v])=>`<span class="card" style="margin-right:.5rem"><b>${esc(v)}</b> <span>${esc(k)}</span></span>`).join("");
  spark();
  fill("pgs",["pg","name","strategy","state","bundles"],
    pgs.map(x=>[esc((x.pg_id||"").slice(0,12)),esc(x.name||""),esc(x.strategy),esc(x.state),esc(JSON.stringify(x.bundles))]));
  fill("jobs",["job","status","entrypoint","returncode"],
    jobs.map(x=>[esc(x.job_id),esc(x.status),esc(x.entrypoint),esc(x.returncode??"")]));
  document.getElementById("objects").innerHTML="<pre>"+esc(JSON.stringify(o,null,1))+"</pre>";
}
async function loadStacks(){
  const s=await j("/api/stacks");
  document.getElementById("stacks").innerHTML=Object.entries(s).map(([w,d])=>
    `<h3>worker ${esc(w.slice(0,12))} pid=${esc(d.pid??"?")} task=${esc((d.current_task||"idle").slice(0,12))}</h3>`+
    `<pre>${esc(Object.entries(d.stacks||{}).map(([t,st])=>t+"\n"+st).join("\n"))}</pre>`).join("")||"no workers";
}
renderTabs();refresh();setInterval(refresh,2000);
</script></body></html>"""


class Dashboard:
    """The dashboard's server over ``client`` (the head), started by
    ``start()`` on a thread of its own."""

    def __init__(self, client=None, host: str = "127.0.0.1", port: int = 8265):
        from ray_tpu_torch.core import context

        self.client = client or context.get_client()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence request logging
                pass

            def _send(self, body: bytes, ctype: str, code: int = 200):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, obj, code: int = 200):
                self._send(json.dumps(obj, default=str).encode(), "application/json", code)

            def do_GET(self):
                c = outer.client
                try:
                    path = self.path.split("?")[0].rstrip("/") or "/"
                    if path == "/":
                        self._send(_PAGE.encode(), "text/html")
                    elif path == "/api/cluster":
                        from ray_tpu_torch.util.state import cluster_status

                        self._json(cluster_status(c))
                    elif path == "/api/nodes":
                        self._json(c.cluster_info("nodes"))
                    elif path == "/api/actors":
                        self._json(c.cluster_info("actors"))
                    elif path == "/api/tasks":
                        self._json(c.cluster_info("tasks"))
                    elif path == "/api/pgs":
                        self._json(c.cluster_info("placement_groups"))
                    elif path == "/api/objects":
                        self._json(c.cluster_info("objects"))
                    elif path == "/api/jobs":
                        from dataclasses import asdict

                        from ray_tpu_torch.job.job_manager import _default_manager

                        jobs = _default_manager.list_jobs() if _default_manager else []
                        self._json([asdict(j) for j in jobs])
                    elif path.startswith("/api/stacks"):
                        # live stacks of every worker, or of those whose id
                        # starts with the path's prefix
                        prefix = path[len("/api/stacks"):].strip("/")
                        self._json(c.dump_worker_stacks(prefix))
                    elif path == "/metrics":
                        from ray_tpu_torch.util.metrics import export_prometheus

                        self._send(export_prometheus(c).encode(), "text/plain; version=0.0.4")
                    else:
                        self._json({"error": "not found"}, 404)
                except Exception as e:  # noqa: BLE001 — the request's error goes back as a 500
                    self._json({"error": str(e)}, 500)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.host = host
        self.port = self._server.server_address[1]
        self._thread: threading.Thread | None = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self):
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True, name="rt-dashboard")
        self._thread.start()
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()


def start_dashboard(port: int = 8265, host: str = "127.0.0.1", client=None) -> Dashboard:
    return Dashboard(client=client, host=host, port=port).start()
