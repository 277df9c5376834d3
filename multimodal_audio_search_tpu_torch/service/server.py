"""HTTP service + web UI (stdlib only — no streamlit in this image).

Counterpart of ``multimodal_audio_search_tpu/service/server.py``, the same
routes, status codes, token gate, path confinement, queue limits and job
records over the port's AudioSearchEngine. It differs in three places: the
UI's software card names PyTorch and its version, ``/api/profile`` records
a torch.profiler Chrome trace (service/stats.py::ProfilerSession), and
``serve`` enables no compilation cache (the JAX package's is TPU-only).

The reference's only boundary is a Streamlit app (audio_search.py:702-1027).
This provides a real service boundary over AudioSearchEngine:

    POST /api/ingest   (body: audio bytes, ?name=)   -> segment summaries
    POST /api/ingest?async=1                          -> 202 {"job": id}
         (a single background worker drains jobs in order — ingest no
          longer occupies an HTTP thread or stalls the client; the
          Streamlit reference blocks its whole UI during processing)
    GET  /api/jobs | /api/jobs/{id}                   -> async job status
    POST /api/stream/open?name=&rate=16000            -> {"session": id}
    POST /api/stream/{id}/chunk (body: int16 PCM)     -> committed segments
    POST /api/stream/{id}/close                       -> tail segments
    GET  /api/search?q=...&k=10[&strategy=]           -> hits + weight info
         (strategy: fusion | fixed_5050 | dynamic_selection |
          adaptive_weighting | audio_only | compare_all — the historical
          strategy surface, streamlit_app_backup.py:62-66)
    GET  /api/stats                                   -> stats JSON export
    GET  /api/metrics.csv                             -> operation log CSV
    GET  /metrics                                     -> Prometheus text
    GET  /api/segments                                -> index listing
    GET  /api/audio/{i}                               -> segment WAV playback
    POST /api/save?path= | /api/load?path=            -> index persistence
    POST /api/delete?source=                          -> drop one file's rows
    POST /api/reset                                   -> clear index + GC
    GET  /                                            -> single-page UI with
         the reference's three tabs (Process / Search / Statistics), the
         sidebar live metrics (audio_search.py:714-765), per-pipeline ingest
         metrics (:798-817), model cards + hardware/software grid + GC +
         JSON export (:881-1027)

Single-writer discipline: every endpoint that touches engine state — reads
included, since `store.meta` can be mid-extend during ingest — serializes
through one lock. On the card that lock also keeps the kernels' per-device
launch plans, split scratch and first-use build to one caller at a time;
every launch goes to the calling thread's current stream.

Hardening (absent in the reference, which bound Streamlit to localhost):
save/load paths are confined to ``data_root`` (resolve + prefix check, so a
CSRF'ing webpage cannot write index files to arbitrary directories), and an
optional ``api_token`` (or MAS_API_TOKEN env) gates the state-changing
endpoints via the X-API-Token header.
"""
from __future__ import annotations

import gc
import io
import json
import os
import queue
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np

from ..audio.wav import write_wav
from .api import AudioSearchEngine

_UI = """<!DOCTYPE html>
<html><head><title>TPU Audio Search</title><style>
body{font-family:system-ui;margin:0;display:flex;min-height:100vh}
aside{width:17rem;background:#f2f4f7;padding:1rem;flex-shrink:0}
main{flex:1;padding:1.2rem 2rem;max-width:64rem}
nav button{margin-right:.5rem;padding:.4rem .8rem}
.tab{display:none}.tab.active{display:block}
.hit{border:1px solid #ccc;border-radius:6px;padding:.6rem;margin:.5rem 0}
.score{font-weight:bold}pre{background:#f6f6f6;padding:.6rem;overflow:auto}
.grid{display:grid;grid-template-columns:repeat(auto-fill,minmax(14rem,1fr));
 gap:.6rem;margin:.6rem 0}
.card{border:1px solid #ddd;border-radius:6px;padding:.6rem;background:#fff}
.card h4{margin:.1rem 0 .3rem 0}.card small{color:#555}
.metric{display:inline-block;margin:.25rem .9rem .25rem 0}
.metric b{display:block;font-size:1.15rem}
.metric span{font-size:.75rem;color:#555}
aside .metric{display:block;margin:.35rem 0}
</style></head><body>
<aside>
<h3>🎛️ System Monitor</h3>
<button onclick="pollStats()">Refresh</button>
<div id="side_sys"></div>
<h4>Database</h4><div id="side_db"></div>
<h4>Pipelines</h4><div id="side_pipes"></div>
<h4>🧠 Fusion</h4>
<small>Query keywords steer ASR vs audio-caption weights (20–80%);
missing embeddings renormalize; threshold 0.1; top-10.</small>
<h4>🔑 API token</h4>
<input id="tok" size="14" placeholder="(if required)"/>
</aside>
<main>
<h1>🎯 Dual Pipeline Audio Search (TPU)</h1>
<nav>
<button onclick="show('process')">📁 Process Audio</button>
<button onclick="show('search')">🔍 Search</button>
<button onclick="show('stats')">📊 Statistics</button>
</nav>
<div id="process" class="tab active">
<h2>Process audio</h2>
<input type="file" id="file" accept=".wav,.flac,.mp3,.m4a,.ogg"/>
<button onclick="ingest()">Process with Both Pipelines</button>
<div id="ingest_metrics"></div>
<div id="ingest_out"></div>
<h3>⚙️ Configuration</h3>
<div class="card">
<label>Segment length
 <input type="range" id="seg_s" min="5" max="30" step="1" value="10"
  oninput="document.getElementById('seg_v').textContent=this.value"/>
 <b id="seg_v">10</b> s</label><br>
<label>ASR model <select id="asr_sel"></select></label>
<label>Caption model <select id="cap_sel"></select></label>
<label>Embedder <select id="emb_sel"></select></label>
<label>Transfer <select id="tr_sel"></select></label>
<button onclick="applyConfig()">Apply (resets index)</button>
<span id="cfg_out"></span></div>
<h3>Ingest jobs</h3><div id="jobs_out"></div>
<h3>Indexed files</h3><div id="sources_out"></div></div>
<div id="search" class="tab">
<h2>Weighted fusion search</h2>
<input id="q" size="50" placeholder="e.g. upbeat music with drums"/>
<select id="strategy">
<option value="fusion" selected>Weighted fusion (production)</option>
<option value="fixed_5050">Fixed 50/50</option>
<option value="dynamic_selection">Dynamic selection</option>
<option value="adaptive_weighting">Adaptive weighting</option>
<option value="audio_only">Audio only</option>
<option value="compare_all">Compare all</option>
</select>
<button onclick="doSearch()">Search with Fusion</button>
<div id="weights"></div><div id="hits"></div></div>
<div id="stats" class="tab"><h2>Statistics</h2>
<button onclick="loadStats()">🔄 Refresh</button>
<button onclick="runGC()">🧹 Clear Index + GC</button>
<a id="dl" download="audio_search_stats.json"><button>⬇ Export JSON
</button></a>
<h3>Model Information</h3><div id="model_cards" class="grid"></div>
<h3>Hardware / Software</h3><div id="hw_grid" class="grid"></div>
<h3>Pipeline Performance</h3><div id="pipe_grid" class="grid"></div>
<h3>Raw</h3><pre id="stats_out"></pre></div>
</main>
<script>
function esc(s){const d=document.createElement('span');
 d.textContent=s==null?'':String(s);return d.innerHTML;}
function authHeaders(){const t=document.getElementById('tok').value;
 return t?{'X-API-Token':t}:{};}
function metric(label,value){return '<span class=metric><b>'+esc(value)+
 '</b><span>'+esc(label)+'</span></span>';}
function show(id){document.querySelectorAll('.tab').forEach(
 t=>t.classList.remove('active'));
 document.getElementById(id).classList.add('active');}
async function ingest(){
 const f=document.getElementById('file').files[0];
 if(!f)return alert('pick an audio file');
 const out=document.getElementById('ingest_out');
 out.innerHTML='<p>⏳ uploading…</p>';
 // async job + polling: processing a long file no longer holds the
 // HTTP request open (the Streamlit reference blocks its whole UI)
 const r=await fetch('/api/ingest?async=1&name='+
  encodeURIComponent(f.name),
  {method:'POST',headers:authHeaders(),body:await f.arrayBuffer()});
 const j0=await r.json();
 if(j0.error){out.innerHTML='<p>❌ '+esc(j0.error)+'</p>';return;}
 let j;
 for(;;){
  j=await (await fetch('/api/jobs/'+encodeURIComponent(j0.job))).json();
  if(j.state==='done'||j.state==='failed'||j.error)break;
  out.innerHTML='<p>⏳ '+esc(j.state)+'…</p>';
  await new Promise(res=>setTimeout(res,700));}
 loadJobs();
 if(j.state!=='done'){out.innerHTML='<p>❌ '+esc(j.error)+'</p>';return;}
 const n=j.segments.length;
 const aok=j.segments.filter(s=>s.asr_success).length;
 const cok=j.segments.filter(s=>s.audio_success).length;
 document.getElementById('ingest_metrics').innerHTML=
  metric('Segments',n)+metric('Index total',j.total)+
  metric('ASR success',aok+'/'+n)+metric('Caption success',cok+'/'+n)+
  metric('ASR rate',n?(100*aok/n).toFixed(0)+'%':'—')+
  metric('Caption rate',n?(100*cok/n).toFixed(0)+'%':'—');
 document.getElementById('ingest_out').innerHTML=
  j.segments.map(s=>'<div class=hit>'+esc(s.segment_id)+' '+
   s.start_time.toFixed(1)+'–'+s.end_time.toFixed(1)+'s — ASR: '+
   esc(s.asr_text||'∅')+' — Caption: '+esc(s.audio_description||'∅')+
   '</div>').join('');
 loadSources();pollStats();}
async function loadJobs(){
 const j=await (await fetch('/api/jobs')).json();
 const jobs=(j.jobs||[]).slice(-8).reverse();
 document.getElementById('jobs_out').innerHTML=jobs.length?
  jobs.map(x=>'<div class=hit>'+esc(x.state)+' — '+esc(x.name)+
   (x.state==='done'?' ('+esc(x.n_segments)+' segment(s))':'')+
   (x.state==='failed'?' — '+esc(x.error):'')+'</div>').join(''):
  '<p>No jobs yet.</p>';}
async function loadSources(){
 const j=await (await fetch('/api/segments')).json();
 const by={};
 (j.segments||[]).forEach(s=>{by[s.source]=(by[s.source]||0)+1;});
 const out=document.getElementById('sources_out');
 out.textContent='';
 const names=Object.keys(by).sort();
 if(!names.length){out.innerHTML='<p>No files indexed yet.</p>';return;}
 // Source names are attacker-controlled (upload filename / ?name=).
 // Build the rows with DOM APIs — never string-spliced event handlers.
 names.forEach(src=>{
  const div=document.createElement('div');div.className='hit';
  div.appendChild(document.createTextNode(
   src+' — '+by[src]+' segment(s) '));
  const b=document.createElement('button');b.textContent='🗑 Remove';
  b.addEventListener('click',()=>delSource(src));
  div.appendChild(b);out.appendChild(div);});}
async function delSource(src){
 if(!confirm('Remove all segments of '+src+'?'))return;
 const r=await fetch('/api/delete?source='+encodeURIComponent(src),
  {method:'POST',headers:authHeaders()});
 const j=await r.json();
 if(j.error)alert(j.error);
 loadSources();pollStats();}
async function doSearch(){
 const q=document.getElementById('q').value;
 const strat=document.getElementById('strategy').value;
 const r=await fetch('/api/search?q='+encodeURIComponent(q)+
  '&strategy='+encodeURIComponent(strat));
 const j=await r.json();
 const w=j.weight_info||{};
 let whtml='';
 if(w.analysis!==undefined&&w.asr_weight!==undefined)
  whtml=metric('ASR weight',(100*w.asr_weight).toFixed(0)+'%')+
   metric('Audio weight',(100*w.audio_weight).toFixed(0)+'%')+
   '<p>🧠 '+esc(w.analysis)+'</p>';
 else if(w.strategy)whtml=metric('Strategy',w.strategy)+
  (w.selected?metric('Selected',w.selected):'');
 if(w.per_strategy){
  // Compare-All side-by-side panel (streamlit_app_backup.py:1110-1133);
  // snippets ride the search response (texts[]) — no /api/segments fetch
  whtml+='<h3>Strategy comparison</h3><div class=grid>'+
   Object.keys(w.per_strategy).map(s=>{
    const o=w.per_strategy[s];
    return '<div class=card><h4>'+esc(s)+'</h4>'+
     (o.top.length?o.top.slice(0,5).map((ix,r)=>{
      return '<small>#'+(r+1)+' '+
       (o.scores[r]!==undefined?o.scores[r].toFixed(3):'')+'</small> '+
       esc(String((o.texts||[])[r]||('seg '+ix)))+'<br>';
     }).join(''):'<small>no hits</small>')+'</div>';
   }).join('')+'</div>';}
 document.getElementById('weights').innerHTML=whtml;
 const fx=(v,d)=>v===undefined?'—':v.toFixed(d);
 document.getElementById('hits').innerHTML=(j.results||[]).map((h,i)=>
  '<div class=hit><span class=score>#'+(i+1)+' '+
  fx(h.fusion_score,3)+'</span> ['+fx(h.start_time,1)+'–'+
  fx(h.end_time,1)+'s]'+
  (h.asr_similarity!==undefined?' ASR:'+fx(h.asr_similarity,3)+
   ' Audio:'+fx(h.audio_similarity,3)+
   ' · eff '+(100*(h.effective_asr_weight||0)).toFixed(0)+'/'+
   (100*(h.effective_audio_weight||0)).toFixed(0)+'%':'')+'<br>'+
  (h.asr_text?'🎤 '+esc(h.asr_text)+'<br>':'')+
  (h.audio_description?'🎵 '+esc(h.audio_description)+'<br>':'')+
  '<audio controls src="/api/audio/'+h.index+'"></audio></div>'
 ).join('')||'<p>no hits above threshold</p>';}
function card(title,rows){return '<div class=card><h4>'+esc(title)+'</h4>'+
 rows.map(r=>'<small>'+esc(r[0])+':</small> '+esc(r[1])+'<br>').join('')+
 '</div>';}
async function loadStats(){
 const r=await fetch('/api/stats');
 const j=await r.json();
 document.getElementById('stats_out').textContent=
  JSON.stringify(j,null,2);
 document.getElementById('dl').href='data:application/json,'+
  encodeURIComponent(JSON.stringify(j,null,2));
 const mi=j.model_info||{};
 document.getElementById('model_cards').innerHTML=
  Object.values(mi).map(m=>card(m.name,[['Type',m.type],['Size',m.size],
   ['Dims',m.dimensions],['About',m.description]])).join('');
 const s=j.system||{};
 document.getElementById('hw_grid').innerHTML=
  card('Hardware',[['Accelerator',s.accelerator],
   ['Devices',s.device_count],
   ['HBM',s.hbm_used_mb.toFixed(0)+' / '+s.hbm_total_mb.toFixed(0)+' MB'],
   ['CPU',s.cpu_percent+'%'],
   ['Memory',s.memory_used_gb.toFixed(1)+' / '+
    s.memory_total_gb.toFixed(1)+' GB']])+
  card('Software',[['Platform',s.platform_info],
   ['Python',s.python_version],['PyTorch',s.torch_version]]);
 document.getElementById('pipe_grid').innerHTML=
  Object.values(j.models||{}).map(p=>card(p.pipeline_name,
   [['Model',p.model_name],['Calls',p.total_calls],
    ['Items',p.total_items],
    ['Avg time',p.avg_processing_time.toFixed(3)+' s'],
    ['Success',(100*p.success_rate).toFixed(1)+'%'],
    ['Load time',p.load_time.toFixed(2)+' s']])).join('');
 renderSidebar(j);}
function renderSidebar(j){
 const s=j.system||{},db=j.database||{};
 document.getElementById('side_sys').innerHTML=
  metric('CPU',s.cpu_percent+'%')+
  metric('Memory',s.memory_used_gb.toFixed(1)+' GB ('+
   s.memory_percent+'%)')+
  metric('Device',s.accelerator+' ×'+s.device_count)+
  (s.hbm_total_mb?metric('HBM',s.hbm_used_mb.toFixed(0)+' / '+
   s.hbm_total_mb.toFixed(0)+' MB'):'');
 document.getElementById('side_db').innerHTML=
  metric('Segments',db.total_segments!=null?db.total_segments:'—');
 document.getElementById('side_pipes').innerHTML=
  Object.values(j.models||{}).map(p=>metric(p.pipeline_name,
   p.total_items+' items · '+(100*p.success_rate).toFixed(0)+'%'))
  .join('');}
async function pollStats(){
 try{const r=await fetch('/api/stats');renderSidebar(await r.json());}
 catch(e){}}
async function runGC(){
 if(!confirm('Clear the index and run GC?'))return;
 await fetch('/api/reset',{method:'POST',headers:authHeaders()});
 loadStats();}
async function loadConfig(){
 try{
  const j=await (await fetch('/api/config')).json();
  document.getElementById('seg_s').value=j.segment_seconds;
  document.getElementById('seg_v').textContent=j.segment_seconds;
  const fill=(id,opts,cur)=>{const s=document.getElementById(id);
   s.textContent='';(opts||[]).forEach(o=>{
    const e=document.createElement('option');
    e.value=o;e.textContent=o;if(o===cur)e.selected=true;
    s.appendChild(e);});};
  fill('asr_sel',j.asr_options,j.asr_preset);
  fill('cap_sel',j.asr_options,j.caption_preset);
  fill('emb_sel',j.embedder_options,j.embedder);
  fill('tr_sel',j.transfer_options,j.transfer_dtype);
 }catch(e){}}
async function applyConfig(){
 if(!confirm('Applying a new configuration resets the index. Continue?'))
  return;
 document.getElementById('cfg_out').textContent='⏳ rebuilding models…';
 const body={segment_seconds:+document.getElementById('seg_s').value,
  asr_preset:document.getElementById('asr_sel').value,
  caption_preset:document.getElementById('cap_sel').value,
  embedder:document.getElementById('emb_sel').value,
  transfer_dtype:document.getElementById('tr_sel').value};
 const r=await fetch('/api/config',{method:'POST',
  headers:Object.assign({'Content-Type':'application/json'},authHeaders()),
  body:JSON.stringify(body)});
 const j=await r.json();
 document.getElementById('cfg_out').textContent=
  j.error?('❌ '+j.error):'✓ applied (models rebuilt, index reset)';
 loadConfig();loadSources();pollStats();}
pollStats();loadSources();loadJobs();loadConfig();
setInterval(pollStats,5000);
</script></body></html>"""


def _slim(segs):
    """Segment records without array payloads (JSON responses)."""
    return [{k: v for k, v in s.items()
             if k not in ("asr_embedding", "audio_embedding",
                          "audio_data")} for s in segs]


class AudioSearchHandler(BaseHTTPRequestHandler):
    engine: AudioSearchEngine = None  # set by serve()
    lock: threading.Lock = None
    data_root: Path = None            # save/load confinement
    api_token: str | None = None      # gates state-changing endpoints
    streams: dict = None              # id -> StreamingIngest (live ingest)
    jobs: dict = None                 # id -> async ingest job record
    jobs_lock: threading.Lock = None
    jobs_q: "queue.Queue" = None      # drained by one worker thread
    max_upload_bytes: int = 1 << 30   # reject larger bodies (memory guard)
    max_jobs: int = 200               # finished-job history bound
    # backpressure for the async queue: the synchronous path implicitly
    # bounds in-flight bytes by open HTTP connections; the 202 path must
    # bound them explicitly or a looping client OOMs the server
    max_queued_jobs: int = 32
    max_queued_bytes: int = 1 << 30
    jobs_queued_bytes: dict = None    # {"v": int}, guarded by jobs_lock

    def _body(self) -> bytes:
        n = int(self.headers.get("Content-Length", "0"))
        if n > self.max_upload_bytes:
            raise ValueError(
                f"upload of {n} bytes exceeds the "
                f"{self.max_upload_bytes}-byte limit")
        return self.rfile.read(n)

    def _send(self, code: int, body: bytes,
              ctype: str = "application/json") -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj, code: int = 200) -> None:
        self._send(code, json.dumps(obj).encode())

    def log_message(self, *a):  # quiet
        pass

    def _resolve_under_root(self, raw: str) -> Path | None:
        """Confine a client-supplied index path to data_root.

        Resolves symlinks/.. then prefix-checks, so `?path=../../etc/x`
        or an absolute path outside the root is rejected (ADVICE round 1:
        CSRF from any webpage could previously write anywhere).
        """
        p = Path(raw)
        if not p.is_absolute():
            p = self.data_root / p
        p = p.resolve()
        root = self.data_root.resolve()
        if p == root or root in p.parents:
            return p
        return None

    def _authorized(self) -> bool:
        if not self.api_token:
            return True
        return self.headers.get("X-API-Token", "") == self.api_token

    def do_GET(self):
        url = urllib.parse.urlparse(self.path)
        qs = urllib.parse.parse_qs(url.query)
        try:
            if url.path == "/":
                self._send(200, _UI.encode(), "text/html")
            elif url.path == "/api/search":
                q_list = qs.get("q", [""])
                k = int(qs.get("k", ["10"])[0])
                strategy = qs.get("strategy", ["fusion"])[0]
                if strategy != "fusion" and len(q_list) > 1:
                    self._json({"error": "strategy search is "
                                "single-query; repeat ?q= only with "
                                "the default fusion strategy"}, 400)
                    return
                if strategy != "fusion" and len(q_list) == 1:
                    with self.lock:
                        results, info = self.engine.search_strategy(
                            q_list[0], strategy, k)
                    slim = [{kk: v for kk, v in r.items()
                             if kk not in ("audio_data",)}
                            for r in results]
                    self._json({"results": slim, "weight_info": info})
                    return
                if len(q_list) > 1:   # repeated ?q= -> one batched dispatch
                    with self.lock:
                        batch = self.engine.search_batch(q_list, k)
                    self._json({"batch": [
                        {"results": [{kk: v for kk, v in r.items()
                                      if kk != "audio_data"}
                                     for r in results],
                         "weight_info": info}
                        for results, info in batch]})
                    return
                with self.lock:
                    results, info = self.engine.search(q_list[0], k)
                slim = [{kk: v for kk, v in r.items()
                         if kk not in ("audio_data",)} for r in results]
                self._json({"results": slim, "weight_info": info})
            elif url.path == "/api/stats":
                with self.lock:
                    body = self.engine.export_stats_json()
                self._send(200, body.encode())
            elif url.path == "/metrics":
                with self.jobs_lock:
                    states = [j["state"] for j in self.jobs.values()]
                    qb = self.jobs_queued_bytes["v"]
                with self.lock:
                    body = self.engine.stats.export_prometheus(
                        {"index_segments": len(self.engine.store),
                         "ingest_jobs_queued": states.count("queued"),
                         "ingest_jobs_running": states.count("running"),
                         "ingest_jobs_queued_bytes": qb})
                self._send(200, body.encode(),
                           "text/plain; version=0.0.4")
            elif url.path == "/api/metrics.csv":
                with self.lock:
                    body = self.engine.stats.log.export_csv()
                self._send(200, body.encode(), "text/csv")
            elif url.path == "/api/config":
                with self.lock:
                    self._json(self.engine.describe_config())
            elif url.path == "/api/jobs":
                with self.jobs_lock:
                    jobs = [{k: v for k, v in j.items()
                             if k != "segments"}
                            for j in self.jobs.values()]
                self._json({"jobs": jobs})
            elif url.path.startswith("/api/jobs/"):
                jid = url.path.rsplit("/", 1)[1]
                with self.jobs_lock:
                    job = self.jobs.get(jid)
                    job = dict(job) if job is not None else None
                if job is None:
                    self._json({"error": "unknown job"}, 404)
                    return
                self._json(job)
            elif url.path == "/api/segments":
                with self.lock:
                    total = len(self.engine.store)
                    meta = list(self.engine.store.meta[:total])
                self._json({"total": total, "segments": meta})
            elif url.path.startswith("/api/audio/"):
                i = int(url.path.rsplit("/", 1)[1])
                with self.lock:
                    if not (0 <= i < len(self.engine.store)):
                        self._json({"error": "segment index out of range"},
                                   404)
                        return
                    audio = self.engine.store.audio(i)
                    sr = self.engine.store.meta[i].get("sample_rate", 16000)
                if audio is None:
                    self._json({"error": "no audio stored"}, 404)
                    return
                import tempfile
                buf = io.BytesIO()
                with tempfile.NamedTemporaryFile(suffix=".wav") as tf:
                    write_wav(tf.name, np.asarray(audio), int(sr))
                    buf.write(open(tf.name, "rb").read())
                self._send(200, buf.getvalue(), "audio/wav")
            else:
                self._json({"error": "not found"}, 404)
        except Exception as e:  # noqa: BLE001 — service boundary
            self._json({"error": str(e)}, 500)

    def do_POST(self):
        url = urllib.parse.urlparse(self.path)
        qs = urllib.parse.parse_qs(url.query)
        try:
            if url.path in ("/api/save", "/api/load", "/api/reset",
                            "/api/delete", "/api/config",
                            "/api/profile") and not self._authorized():
                self._json({"error": "missing or bad X-API-Token"}, 401)
                return
            if url.path == "/api/config":
                # chunk-duration + model selection at runtime (the
                # historical UI's slider/dropdowns,
                # streamlit_app_backup.py:875, clean_audio_search.py:32-47);
                # rebuilds pipelines and RESETS the index
                body = json.loads(self._body() or b"{}")
                if not isinstance(body, dict):
                    # a bare number/list would TypeError below at set()
                    # — still a client error, not a 500
                    self._json({"error": "config body must be a JSON "
                                         "object"}, 400)
                    return
                allowed = {"segment_seconds", "min_segment_seconds",
                           "asr_preset", "caption_preset", "embedder",
                           "transfer_dtype"}
                bad = set(body) - allowed
                if bad:
                    self._json({"error": f"unknown config keys {bad}"},
                               400)
                    return
                try:
                    with self.lock:
                        out = self.engine.reconfigure(**body)
                except (ValueError, TypeError) as e:
                    # bad values (range/unknown preset/wrong type) are a
                    # client error, not a server fault
                    self._json({"error": str(e)}, 400)
                    return
                self._json(out)
                return
            if url.path == "/api/ingest":
                data = self._body()
                name = qs.get("name", ["upload"])[0]
                if qs.get("async", ["0"])[0].lower() in ("1", "true",
                                                         "yes"):
                    import uuid
                    jid = uuid.uuid4().hex[:12]
                    job = {"id": jid, "name": name, "state": "queued",
                           "submitted": time.time(), "bytes": len(data)}
                    with self.jobs_lock:
                        queued = sum(1 for j in self.jobs.values()
                                     if j["state"] == "queued")
                        if queued >= self.max_queued_jobs or \
                                self.jobs_queued_bytes["v"] + len(data) \
                                > self.max_queued_bytes:
                            self._json({"error": "ingest queue full — "
                                        "retry later"}, 429)
                            return
                        self.jobs_queued_bytes["v"] += len(data)
                        done = [k for k, j in self.jobs.items()
                                if j["state"] in ("done", "failed")]
                        for k in done[: max(0, len(self.jobs) + 1
                                            - self.max_jobs)]:
                            del self.jobs[k]
                        self.jobs[jid] = job
                    self.jobs_q.put((jid, data, name))
                    self._json({"job": jid, "state": "queued"}, 202)
                    return
                with self.lock:
                    segs = self.engine.ingest(data, name)
                self._json({"segments": _slim(segs),
                            "total": len(self.engine.store)})
            elif url.path == "/api/save":
                path = self._resolve_under_root(
                    qs.get("path", ["index"])[0])
                if path is None:
                    self._json({"error": "path outside data root"}, 403)
                    return
                with self.lock:
                    self.engine.save_index(path)
                self._json({"saved": str(path)})
            elif url.path == "/api/load":
                path = self._resolve_under_root(
                    qs.get("path", ["index"])[0])
                if path is None:
                    self._json({"error": "path outside data root"}, 403)
                    return
                with self.lock:
                    self.engine.load_index(path)
                self._json({"loaded": str(path),
                            "total": len(self.engine.store)})
            elif url.path == "/api/delete":
                source = qs.get("source", [None])[0]
                if not source:
                    self._json({"error": "missing ?source="}, 400)
                    return
                with self.lock:
                    removed = self.engine.delete_source(source)
                self._json({"removed": removed,
                            "total": len(self.engine.store)})
            elif url.path == "/api/stream/open":
                from ..pipelines.streaming import StreamingIngest
                import uuid
                name = qs.get("name", ["stream"])[0]
                with self.lock:
                    sid = uuid.uuid4().hex[:12]
                    self.streams[sid] = StreamingIngest(
                        self.engine.ingest_pipeline, self.engine.store,
                        self.engine.cfg, source_name=name)
                self._json({"session": sid})
            elif url.path.startswith("/api/stream/"):
                parts = url.path.rsplit("/", 2)
                sid, action = parts[1], parts[2]
                stream = self.streams.get(sid)
                if stream is None:
                    self._json({"error": "unknown stream session"}, 404)
                    return
                if action == "chunk":
                    pcm = np.frombuffer(self._body(), np.int16) \
                        .astype(np.float32) / 32767.0
                    rate = int(qs.get("rate", ["16000"])[0])
                    with self.lock:
                        segs = stream.feed(pcm, rate)
                    self._json({
                        "segments": _slim(segs),
                        "buffered_s": round(stream.buffered_seconds, 2),
                        "total": len(self.engine.store)})
                elif action == "close":
                    with self.lock:
                        segs = stream.flush()
                        self.streams.pop(sid, None)
                    self._json({"segments": _slim(segs),
                                "total": len(self.engine.store)})
                else:
                    self._json({"error": "not found"}, 404)
            elif url.path == "/api/profile":
                # capture a torch.profiler Chrome trace around one search
                # (true device timelines — the reference's telemetry is
                # wall-clock only, SURVEY §5)
                from .stats import ProfilerSession
                q = qs.get("q", ["profiling query"])[0]
                import time as _t
                trace_dir = (self.data_root.resolve() / "traces"
                             / str(int(_t.time())))
                trace_dir.mkdir(parents=True, exist_ok=True)
                with self.lock:
                    with ProfilerSession(str(trace_dir)):
                        results, _ = self.engine.search(q)
                self._json({"trace_dir": str(trace_dir),
                            "hits": len(results)})
            elif url.path == "/api/reset":
                # the reference's "Force Garbage Collection" button
                # (audio_search.py:993-998) + model-comparison index reset
                with self.lock:
                    self.engine.reset_index()
                    collected = gc.collect()
                self._json({"reset": True, "gc_collected": collected})
            else:
                self._json({"error": "not found"}, 404)
        except ValueError as e:
            self._json({"error": str(e)}, 400)
        except Exception as e:  # noqa: BLE001
            self._json({"error": str(e)}, 500)


def _ingest_worker(handler_cls) -> None:
    """Single background worker: drains async ingest jobs in submission
    order under the same single-writer lock as the synchronous path, so
    async mode changes WHO waits (a poller instead of a blocked HTTP
    client), never the store's consistency model."""
    while True:
        item = handler_cls.jobs_q.get()
        if item is None:        # shutdown sentinel (tests)
            return
        jid, data, name = item
        with handler_cls.jobs_lock:
            handler_cls.jobs_queued_bytes["v"] -= len(data)
            job = handler_cls.jobs.get(jid)
            if job is None:     # pruned before it ran — drop
                continue
            job["state"] = "running"
            job["started"] = time.time()
        try:
            with handler_cls.lock:
                # a backlog of queued jobs defers the per-job IVF
                # prewarm; the engine rebuilds once at drain end
                handler_cls.engine._defer_prewarm = \
                    not handler_cls.jobs_q.empty()
                try:
                    segs = handler_cls.engine.ingest(data, name)
                finally:
                    handler_cls.engine._defer_prewarm = False
                if handler_cls.jobs_q.empty():
                    handler_cls.engine._prewarm_searcher()
            out = {"state": "done", "segments": _slim(segs),
                   "n_segments": len(segs),
                   "total": len(handler_cls.engine.store)}
        except Exception as e:  # noqa: BLE001 — job boundary
            out = {"state": "failed", "error": str(e)}
        with handler_cls.jobs_lock:
            job.update(out)
            job["finished"] = time.time()


def serve(
    engine: AudioSearchEngine | None = None,
    host: str = "127.0.0.1",
    port: int = 8527,                      # reference port (README.md:59-66)
    block: bool = True,
    warmup: bool = False,
    data_root: str | os.PathLike | None = None,
    api_token: str | None = None,
) -> ThreadingHTTPServer:
    """Build the engine + HTTP server (reference UI surface,
    the reference's audio_search.py:702-711 re-expressed as an API).

    Contract: with ``block=True`` this runs the accept loop itself and
    never returns. With ``block=False`` it RETURNS the constructed
    server WITHOUT serving — the caller owns the accept-loop thread
    (``threading.Thread(target=srv.serve_forever, daemon=True)``), as
    every test and tools/soak.py do. A client request against a
    block=False server with no such thread waits in the TCP backlog
    forever with zero CPU — indistinguishable from a backend hang
    (this cost two sessions of round-4/5 soak attempts).
    """
    if engine is None:
        # same MAS_* env semantics as the CLI entry point, so a bare
        # `python -m ...service.server` honors DEPLOYMENT.md's knobs
        from ..config import config_from_env
        engine = AudioSearchEngine(cfg=config_from_env())
    engine.load_all_models(warmup=warmup)
    root = Path(data_root if data_root is not None
                else os.environ.get("MAS_DATA_ROOT", os.getcwd()))
    token = api_token if api_token is not None \
        else os.environ.get("MAS_API_TOKEN") or None
    handler = type("Handler", (AudioSearchHandler,),
                   {"engine": engine, "lock": threading.Lock(),
                    "data_root": root, "api_token": token,
                    "streams": {}, "jobs": {},
                    "jobs_lock": threading.Lock(),
                    "jobs_q": queue.Queue(),
                    "jobs_queued_bytes": {"v": 0}})
    threading.Thread(target=_ingest_worker, args=(handler,),
                     daemon=True, name="ingest-worker").start()
    srv = ThreadingHTTPServer((host, port), handler)
    if block:
        print(f"serving on http://{host}:{port} (data root: {root})")
        srv.serve_forever()
    return srv


if __name__ == "__main__":
    serve()
