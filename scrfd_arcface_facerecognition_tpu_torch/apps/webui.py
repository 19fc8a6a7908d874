"""Single-page web UI served at '/' by ``apps/webapp.py``.

The port's own copy of the JAX package's ``apps/webui.py``: the same page
(stats tiles, the visit-JSON form, the fetch-from-API form with its
localStorage-backed API-config panel, the persons / low-similarity / face
comparison tabs, the per-person drill-down, the image modal, the merge,
clear-database and clear-cache actions), with one word changed: the
backend named in the page's title.
"""

INDEX_HTML = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>Smart Face Recognition — CUDA</title>
<style>
  :root { --bg:#f6f7f9; --card:#fff; --line:#e2e5ea; --ink:#1c2430;
          --dim:#687180; --acc:#2563eb; --bad:#dc2626; --ok:#16a34a; }
  * { box-sizing:border-box; }
  body { font-family:system-ui,sans-serif; margin:0; background:var(--bg);
         color:var(--ink); }
  header { background:var(--card); border-bottom:1px solid var(--line);
           padding:14px 28px; display:flex; align-items:baseline; gap:14px; }
  header h1 { font-size:18px; margin:0; }
  header span { color:var(--dim); font-size:13px; }
  main { max-width:1100px; margin:0 auto; padding:20px 28px; }
  .tiles { display:flex; gap:12px; flex-wrap:wrap; margin-bottom:18px; }
  .tile { background:var(--card); border:1px solid var(--line);
          border-radius:10px; padding:12px 20px; min-width:130px; }
  .tile b { display:block; font-size:22px; }
  .tile span { color:var(--dim); font-size:12px; }
  .row { display:flex; gap:16px; flex-wrap:wrap; margin-bottom:18px; }
  .card { background:var(--card); border:1px solid var(--line);
          border-radius:10px; padding:16px; flex:1; min-width:320px; }
  .card h3 { margin:0 0 10px; font-size:14px; }
  textarea { width:100%; height:90px; font-family:monospace; font-size:12px;
             border:1px solid var(--line); border-radius:6px; padding:8px; }
  input { border:1px solid var(--line); border-radius:6px; padding:6px 8px;
          margin:2px 4px 2px 0; }
  button { background:var(--acc); color:#fff; border:0; border-radius:6px;
           padding:7px 14px; cursor:pointer; font-size:13px; margin:4px 6px 0 0; }
  button.warn { background:var(--bad); }
  button.plain { background:#64748b; }
  .tabs { display:flex; gap:4px; margin-bottom:0; }
  .tabs div { padding:8px 16px; border:1px solid var(--line);
              border-bottom:0; border-radius:8px 8px 0 0; cursor:pointer;
              background:#eef0f4; font-size:13px; }
  .tabs div.active { background:var(--card); font-weight:600; }
  #tabbody { background:var(--card); border:1px solid var(--line);
             border-radius:0 10px 10px 10px; padding:16px; min-height:180px; }
  table { border-collapse:collapse; width:100%; font-size:13px; }
  th, td { text-align:left; border-bottom:1px solid var(--line);
           padding:6px 8px; }
  th { color:var(--dim); font-weight:600; }
  #status { margin:10px 0; font-size:13px; color:var(--dim); }
  .pill { display:inline-block; padding:1px 8px; border-radius:10px;
          font-size:12px; }
  .pill.ok { background:#dcfce7; color:var(--ok); }
  .pill.bad { background:#fee2e2; color:var(--bad); }
  img.thumb { width:48px; height:48px; object-fit:cover; border-radius:6px;
              background:#eef0f4; display:block; }
  .visit-strip img { width:40px; height:40px; object-fit:cover;
                     border-radius:4px; margin:0 2px 2px 0; }
  #progress { display:none; margin:8px 0; }
  #progress .bar { height:8px; background:#eef0f4; border-radius:4px;
                   overflow:hidden; }
  #progress .bar div { height:100%; background:var(--acc); width:0; }
  #progress span { font-size:12px; color:var(--dim); }
</style>
</head>
<body>
<header><h1>Smart Face Recognition</h1>
<span>TPU-native SCRFD + ArcFace</span></header>
<main>
  <div class="tiles" id="tiles"></div>

  <div class="row">
    <div class="card">
      <h3>Process visits (paste JSON)</h3>
      <textarea id="visitjson" placeholder='{"visits": [{"id": 1, "image": "http://...", ...}]}'></textarea>
      <label>max <input id="maxvisits" type="number" value="500" style="width:80px"></label>
      <label><input id="saveimgs" type="checkbox" checked> save images</label>
      <label><input id="clearex" type="checkbox"> clear existing</label>
      <br><button onclick="processVisits()">Process</button>
    </div>
    <div class="card">
      <h3>Fetch visits from API
        <button class="plain" style="float:right;padding:3px 9px"
                onclick="toggleApiConfig()">config</button></h3>
      <label>start <input id="fstart" type="date"></label>
      <label>end <input id="fend" type="date"></label><br>
      <label>page <input id="fpage" type="number" value="0" style="width:60px"></label>
      <label>limit <input id="flimit" type="number" value="100" style="width:70px"></label>
      <label><input id="fclear" type="checkbox"> clear existing</label>
      <br><button onclick="fetchVisitsFromApi()">Fetch &amp; process</button>
      <div id="fetchout" style="font-size:12px;color:var(--dim)"></div>
      <div id="apiconfig" style="display:none;border-top:1px solid var(--line);
           margin-top:10px;padding-top:8px">
        <label>API URL <input id="capiurl" style="width:95%" placeholder="https://..."></label><br>
        <label>start time <input id="cstime" value="00:00:00" style="width:90px"></label>
        <label>end time <input id="cetime" value="23:59:59" style="width:90px"></label>
        <label><input id="callbranch" type="checkbox" checked> all branches</label><br>
        <label>API key <input id="capikey" style="width:44%"></label>
        <label>auth token <input id="cauthtok" style="width:44%"></label><br>
        <button class="plain" onclick="saveApiConfig()">Save</button>
        <button class="plain" onclick="loadApiConfigFromServer()">Load server config</button>
        <button class="plain" onclick="testApiConnection()">Test connection</button>
        <div id="apistatus" style="font-size:12px;margin-top:4px"></div>
      </div>
    </div>
    <div class="card">
      <h3>Actions</h3>
      <label>merge threshold <input id="mergeth" type="number" step="0.05" value="0.8" style="width:70px"></label>
      <button onclick="mergeDuplicates()">Merge duplicates</button><br>
      <button class="plain" onclick="clearCache()">Clear image cache</button>
      <button class="warn" onclick="clearDb()">Clear database</button>
    </div>
  </div>

  <div id="status"></div>
  <div id="progress"><div class="bar"><div id="progbar"></div></div>
    <span id="progtext"></span></div>

  <div id="modal" onclick="closeModal()" style="display:none;position:fixed;
       inset:0;background:rgba(12,16,24,.82);z-index:50;cursor:zoom-out;
       align-items:center;justify-content:center">
    <img id="modalimg" style="max-width:92vw;max-height:92vh;
         border-radius:8px" alt="">
  </div>

  <div class="tabs" id="tabs">
    <div data-tab="persons" class="active" onclick="showTab('persons')">Clustered persons</div>
    <div data-tab="lowsim" onclick="showTab('lowsim')">Low similarity</div>
    <div data-tab="compare" onclick="showTab('compare')">Face comparison</div>
  </div>
  <div id="tabbody"></div>
</main>
<script>
const $ = (id) => document.getElementById(id);
// API-sourced strings (names, urls, reasons — ultimately fetched from an
// external service) are interpolated into innerHTML: escape them, and only
// let http(s) URLs become hrefs (blocks stored XSS / javascript: links).
const esc = (s) => String(s ?? '').replace(/[&<>"']/g,
  (c) => ({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[c]));
const safeUrl = (u) => {
  const s = String(u ?? '');
  return (s.startsWith('http://') || s.startsWith('https://')) ? esc(s) : '';
};
const status = (msg, ok=true) =>
  $('status').innerHTML = `<span class="pill ${ok ? 'ok' : 'bad'}">${esc(msg)}</span>`;

async function api(path, opts) {
  const r = await fetch(path, opts);
  const data = await r.json().catch(() => ({}));
  if (!r.ok) throw new Error(data.error || r.status);
  return data;
}

async function loadStats() {
  const s = await api('/api/stats');
  const names = {total_persons:'persons', total_visits:'visits',
                 total_images:'images', low_similarity_count:'low similarity',
                 recent_activity:'recent (24h)'};
  $('tiles').innerHTML = Object.entries(names).map(
    ([k, label]) => `<div class="tile"><b>${s[k] ?? 0}</b><span>${label}</span></div>`
  ).join('');
}

let activeTab = 'persons';
function showTab(name) {
  activeTab = name;
  document.querySelectorAll('#tabs div').forEach(
    d => d.classList.toggle('active', d.dataset.tab === name));
  renderTab();
}

async function renderTab() {
  const el = $('tabbody');
  el.innerHTML = 'Loading…';
  try {
    if (activeTab === 'persons') {
      const { groups } = await api('/api/person-groups');
      el.innerHTML = groups.length ? '<table><tr><th></th><th>id</th><th>name</th>' +
        '<th>visits</th><th>matches</th><th>quality</th><th>last seen</th></tr>' +
        groups.map(g => `<tr class="person-row" onclick="showPerson(${g.person_id})" style="cursor:pointer">` +
          `<td><img class="thumb" data-path="${esc(g.image_path)}" alt=""></td>` +
          `<td>${g.person_id}</td><td>${esc(g.name)}` +
          `<div class="visit-strip">${(g.images ?? []).slice(0, 6).map(
             v => `<img data-path="${esc(v.image_path)}" title="visit ${esc(v.visit_id)} (${((v.similarity ?? 0) * 100).toFixed(0)}%)" alt="">`
           ).join('')}</div></td>` +
          `<td>${g.visit_count}</td><td>${g.match_count}</td>` +
          `<td>${(g.face_quality ?? 0).toFixed(2)}</td><td>${esc(g.last_seen)}</td></tr>`
        ).join('') + '</table>' : 'No persons yet.';
      loadThumbs(el);
    } else if (activeTab === 'lowsim') {
      const { images } = await api('/api/low-similarity-images');
      el.innerHTML = images.length ? '<table><tr><th></th><th>visit</th><th>customer</th>' +
        '<th>similarity %</th><th>reason</th><th>when</th></tr>' +
        images.map(i => `<tr><td><img class="thumb" data-path="${esc(i.image_path)}" alt=""></td>` +
          `<td>${esc(i.visit_id)}</td><td>${esc(i.customer_id)}</td>` +
          `<td>${(i.similarity ?? 0).toFixed(1)}</td><td>${esc(i.reason)}</td>` +
          `<td>${esc(i.processed_at)}</td></tr>`).join('') + '</table>'
        : 'No low-similarity images.';
      loadThumbs(el);
    } else {
      el.innerHTML = `<p>POST records to
        <code>/api/process-face-comparisons-from-api</code> — results are
        written as <code>face_comparison_results_*.json</code>.</p>
        <textarea id="cmpjson" placeholder='[{"id": "v1", "image": "http://...", "refImage": "http://...", "isConverted": true}]'></textarea>
        <br><button onclick="runComparisons()">Run comparisons</button>
        <div id="cmpout"></div>`;
    }
  } catch (e) { el.textContent = 'Error: ' + e.message; }
}

// Person drill-down: click a row -> GET /api/person/{id} -> visit detail
// (the reference UI's per-person fetch flow, templates/index.html:663-1797
// served by smart_face_recognition.py:2989).
async function showPerson(id) {
  const el = $('tabbody');
  el.innerHTML = 'Loading…';
  try {
    const p = await api('/api/person/' + id);
    const visits = p.visits ?? [];
    el.innerHTML =
      `<div id="person-detail">` +
      `<button onclick="renderTab()">&larr; Back to persons</button>` +
      `<h3><img class="thumb" data-path="${esc(p.image_path)}" alt=""> ` +
      `${esc(p.name)} <small>(id ${esc(p.id)})</small></h3>` +
      `<p>quality ${(p.face_quality ?? 0).toFixed(2)} · ` +
      `matches ${p.match_count ?? 0} · created ${esc(p.created_at)} · ` +
      `last seen ${esc(p.last_seen)}</p>` +
      (visits.length ?
        '<table><tr><th></th><th>visit</th><th>customer</th>' +
        '<th>similarity %</th><th>entry time</th><th>source</th></tr>' +
        visits.map(v =>
          `<tr><td><img class="thumb" data-path="${esc(v.saved_image_path)}" alt=""></td>` +
          `<td>${esc(v.visit_id)}</td><td>${esc(v.customer_id)}</td>` +
          `<td>${((v.similarity ?? 0) * 100).toFixed(1)}</td>` +
          `<td>${esc(v.entry_time)}</td>` +
          `<td>${safeUrl(v.image_url) ? `<a href="${safeUrl(v.image_url)}" target="_blank" rel="noopener">url</a>` : ''}</td></tr>`
        ).join('') + '</table>'
        : '<p>No visits recorded.</p>') +
      `</div>`;
    loadThumbs(el);
  } catch (e) { el.textContent = 'Error: ' + e.message; }
}

// thumbnails: hydrate <img data-path> via /api/image-base64 (the
// reference UI's rendering route, templates/index.html) — local paths
// only; remote URLs load directly.
async function loadThumbs(root) {
  for (const img of root.querySelectorAll('img[data-path]')) {
    const p = img.dataset.path;
    if (!p) { img.style.visibility = 'hidden'; continue; }
    img.style.cursor = 'zoom-in';
    img.onclick = (ev) => { ev.stopPropagation(); openModal(img); };
    if (/^https?:/.test(p)) { img.src = p; continue; }
    try {
      const { image } = await api('/api/image-base64/' + encodeURI(p));
      img.src = image;
    } catch (e) { img.style.visibility = 'hidden'; }
  }
}

// click-to-enlarge image modal (the reference UI's openModal/closeModal,
// templates/index.html:922-951); local paths re-fetch through /api/image/
// for the full-resolution file instead of the 300px base64 thumbnail.
function openModal(img) {
  const p = img.dataset.path || '';
  $('modalimg').src = /^https?:/.test(p) || !p
    ? img.src : '/api/image/' + encodeURI(p);
  $('modal').style.display = 'flex';
}
function closeModal() { $('modal').style.display = 'none'; }
document.addEventListener('keydown',
  (e) => { if (e.key === 'Escape') closeModal(); });

let progTimer = null;
function pollProgress(on) {
  const box = $('progress');
  if (!on) { clearInterval(progTimer); progTimer = null;
             box.style.display = 'none'; return; }
  box.style.display = 'block';
  progTimer = setInterval(async () => {
    try {
      const p = await api('/api/job-progress');
      const pct = p.total ? Math.round(100 * p.done / p.total) : 0;
      $('progbar').style.width = pct + '%';
      $('progtext').textContent =
        `${p.status}: ${p.stage} ${p.done}/${p.total} (${pct}%)`;
    } catch (e) {}
  }, 800);
}

async function processVisits() {
  try {
    const body = JSON.parse($('visitjson').value || '{}');
    body.max_visits = parseInt($('maxvisits').value) || 500;
    body.save_images = $('saveimgs').checked;
    body.clear_existing = $('clearex').checked;
    status('Processing…');
    pollProgress(true);
    const r = await api('/api/process-visits', {method:'POST',
      headers:{'Content-Type':'application/json'}, body: JSON.stringify(body)});
    status('Done: ' + JSON.stringify(r.results));
    loadStats(); renderTab();
  } catch (e) { status('Failed: ' + e.message, false); }
  finally { pollProgress(false); }
}

async function runComparisons() {
  try {
    const records = JSON.parse($('cmpjson').value || '[]');
    const r = await api('/api/process-face-comparisons-from-api',
      {method:'POST', headers:{'Content-Type':'application/json'},
       body: JSON.stringify({records})});
    // summary tiles + a per-comparison result table (reference UI's
    // face-comparison tab detail, templates/index.html)
    const s = r.summary;
    // comparisons[i] and confidences[i] describe the same record by
    // construction (apps/webapp.py builds both from the engine results)
    const rows = (r.comparisons ?? []).map((c, i) => {
      const extra = (r.confidences ?? [])[i] ?? {};
      const agree = extra.api_vs_our_match;
      return `<tr><td>${esc(c.fileName)}</td><td>${esc(c.event)}</td>` +
        `<td>${esc(c.camera)}</td><td>${esc(c.eventId)}</td>` +
        `<td>${c.approve ? 'yes' : 'no'}</td>` +
        `<td class="${c.match_status === 'SAME' ? 'ok' : ''}">${esc(c.match_status)}</td>` +
        `<td>${extra.confidence != null ? (extra.confidence * 100).toFixed(1) + '%' : ''}</td>` +
        `<td>${agree == null ? '' : agree ? '&#10003;' : '&#10007;'}</td>` +
        `<td>${esc(extra.error)}</td></tr>`;
    }).join('');
    $('cmpout').innerHTML =
      `<p><b>${s.total_comparisons}</b> compared · ` +
      `<b>${s.same_person}</b> same · <b>${s.different_person}</b> different · ` +
      `<b>${s.errors}</b> errors · accuracy vs API <b>${(+r.accuracy_vs_api).toFixed(1)}%</b> · ` +
      `saved to <code>${esc(r.results_file)}</code></p>` +
      (rows ? '<table><tr><th>file</th><th>event</th><th>camera</th>' +
        '<th>eventId</th><th>API approve</th><th>our match</th>' +
        '<th>confidence</th><th>agree</th><th>error</th></tr>' +
        rows + '</table>' : '');
  } catch (e) { $('cmpout').textContent = 'Failed: ' + e.message; }
}

// API configuration panel (the reference UI's api-input-form:
// save/load via localStorage, server defaults via GET /api/config,
// browser-direct test fetch — templates/index.html:1316-1444).
function toggleApiConfig() {
  const el = $('apiconfig');
  el.style.display = el.style.display === 'none' ? 'block' : 'none';
}
function apiStatus(msg, ok=true) {
  // msg can embed text from the user-configured EXTERNAL API (statusText,
  // error bodies) — escape it like status() does, or a hostile endpoint
  // injects markup into a page whose localStorage holds the API creds.
  $('apistatus').innerHTML =
    `<span class="pill ${ok ? 'ok' : 'bad'}">${esc(msg)}</span>`;
}
function apiConfigBody() {
  return {
    api_url: $('capiurl').value || undefined,
    start_time: $('cstime').value || undefined,
    end_time: $('cetime').value || undefined,
    all_branch: $('callbranch').checked,
    api_key: $('capikey').value || undefined,
    auth_token: $('cauthtok').value || undefined,
  };
}
function saveApiConfig() {
  localStorage.setItem('apiConfig', JSON.stringify({
    ...apiConfigBody(), start_date: $('fstart').value,
    end_date: $('fend').value, page: $('fpage').value,
    limit: $('flimit').value}));
  apiStatus('API configuration saved');
}
function loadApiConfig() {
  const saved = localStorage.getItem('apiConfig');
  if (!saved) return;
  const c = JSON.parse(saved);
  $('capiurl').value = c.api_url ?? ''; $('cstime').value = c.start_time ?? '00:00:00';
  $('cetime').value = c.end_time ?? '23:59:59';
  $('callbranch').checked = c.all_branch !== false;
  $('capikey').value = c.api_key ?? ''; $('cauthtok').value = c.auth_token ?? '';
  if (c.start_date) $('fstart').value = c.start_date;
  if (c.end_date) $('fend').value = c.end_date;
  if (c.page) $('fpage').value = c.page;
  if (c.limit) $('flimit').value = c.limit;
}
async function loadApiConfigFromServer() {
  try {
    const { config } = await api('/api/config');
    if (config.API_URL) $('capiurl').value = config.API_URL;
    if (config.START_DATE) $('fstart').value = config.START_DATE;
    if (config.END_DATE) $('fend').value = config.END_DATE;
    // credentials come back redacted ('***') by design — never filled in
    apiStatus('Loaded server api_config.txt (credentials stay server-side)');
  } catch (e) { apiStatus('No server config: ' + e.message, false); }
}
async function testApiConnection() {
  const url = $('capiurl').value;
  if (!url) { apiStatus('Set an API URL first', false); return; }
  apiStatus('Testing…');
  try {
    const params = new URLSearchParams({
      startDate: $('fstart').value || '', endDate: $('fend').value || '',
      page: $('fpage').value || '0', limit: '1',
      startTime: $('cstime').value || '', endTime: $('cetime').value || '',
      allBranch: String($('callbranch').checked)});
    const headers = {};
    if ($('capikey').value) headers['X-API-Key'] = $('capikey').value;
    if ($('cauthtok').value)
      headers['Authorization'] = 'Bearer ' + $('cauthtok').value;
    const r = await fetch(`${url}?${params}`, {headers});
    if (!r.ok) throw new Error(r.status + ' ' + r.statusText);
    const data = await r.json();
    const n = Array.isArray(data) ? data.length : (data.data ?? []).length;
    apiStatus(`Connection OK — ${n} visit(s) in first page`);
  } catch (e) { apiStatus('Connection failed: ' + e.message, false); }
}

async function fetchVisitsFromApi() {
  try {
    status('Fetching from API…');
    pollProgress(true);
    const r = await api('/api/process-visits-from-api', {method:'POST',
      headers:{'Content-Type':'application/json'},
      body: JSON.stringify({
        ...apiConfigBody(),
        start_date: $('fstart').value || undefined,
        end_date: $('fend').value || undefined,
        page: parseInt($('fpage').value) || 0, limit: parseInt($('flimit').value) || 100,
        clear_existing: $('fclear').checked})});
    $('fetchout').textContent = `fetched ${r.fetched} visits`;
    status('Done: ' + JSON.stringify(r.results));
    loadStats(); renderTab();
  } catch (e) { status('Failed: ' + e.message, false); }
  finally { pollProgress(false); }
}

async function mergeDuplicates() {
  try {
    const r = await api('/api/merge-duplicates', {method:'POST',
      headers:{'Content-Type':'application/json'},
      body: JSON.stringify({threshold: parseFloat($('mergeth').value)})});
    // merge summary: which persons were folded into which (plain text —
    // status() escapes once; pre-escaping here double-rendered entities)
    const detail = (r.pairs ?? []).map(p =>
      `${p.name || 'person'} #${p.merged} -> #${p.kept}`).join(', ');
    status(r.message + (detail ? ' — ' + detail : ''));
    loadStats(); renderTab();
  } catch (e) { status('Failed: ' + e.message, false); }
}
async function clearDb() {
  if (!confirm('Clear ALL persons/visits?')) return;
  const r = await api('/api/clear-database', {method:'POST'});
  status(r.message); loadStats(); renderTab();
}
async function clearCache() {
  const r = await api('/api/clear-cache', {method:'POST'});
  status(r.message);
}

loadStats(); renderTab(); loadApiConfig();
setInterval(loadStats, 15000);
</script>
</body>
</html>"""
