"""Browser frontend for the multi-tenant server (the port's copy of
``bitdelta_tpu/serving/frontend.py``): one static page served at
``GET /`` that consumes the NDJSON ``/generate`` stream and renders one
pane per tenant.
"""

INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>bitdelta multi-tenant demo</title>
<style>
 body { font-family: system-ui, sans-serif; margin: 1rem; background:#fafafa }
 #grid { display: grid; grid-template-columns: repeat(3, 1fr); gap: .6rem }
 .pane { border: 1px solid #ccc; border-radius: 8px; padding: .5rem;
         background: #fff; min-height: 9rem; cursor: pointer }
 .pane.selected { outline: 3px solid #4a90d9 }
 .pane h3 { margin: 0 0 .4rem; font-size: .9rem; color: #333 }
 .pane pre { white-space: pre-wrap; font-size: .85rem; margin: 0 }
 #bar { display: flex; gap: .5rem; margin-bottom: .8rem }
 #prompt { flex: 1; padding: .5rem }
 #history { color:#666; font-size:.8rem; white-space:pre-wrap;
            margin-bottom:.6rem }
</style></head><body>
<h2>bitdelta — one base model, N 1-bit deltas</h2>
<div id="history"></div>
<div id="bar">
 <input id="prompt" placeholder="say something..." />
 <button id="send">send to all tenants</button>
</div>
<div id="grid"></div>
<script>
let history = [];   // shared conversation: [{role, content}]
let panes = {};

async function init() {
  const r = await fetch('/models');
  const models = (await r.json()).models;
  const grid = document.getElementById('grid');
  for (const m of models) {
    const d = document.createElement('div');
    d.className = 'pane'; d.id = 'pane-' + m;
    d.innerHTML = `<h3>${m}</h3><pre></pre>`;
    d.onclick = () => choose(m);
    grid.appendChild(d);
    panes[m] = d.querySelector('pre');
  }
}
function renderHistory() {
  document.getElementById('history').textContent =
    history.map(m => m.role + ': ' + m.content).join('\\n');
}
function choose(model) {
  // "choose this reply": the clicked tenant's answer joins the shared
  // history; everyone continues from it.
  const text = panes[model].textContent;
  if (!text) return;
  history.push({role: 'assistant', content: text});
  renderHistory();
  for (const m in panes) panes[m].textContent = '';
  document.querySelectorAll('.pane').forEach(p => p.classList.remove('selected'));
  document.getElementById('pane-' + model).classList.add('selected');
}
async function send() {
  const input = document.getElementById('prompt');
  if (!input.value) return;
  history.push({role: 'user', content: input.value});
  renderHistory();
  input.value = '';
  for (const m in panes) panes[m].textContent = '';
  const resp = await fetch('/generate', {method: 'POST',
    body: JSON.stringify({messages: history, max_new_tokens: 128})});
  const reader = resp.body.getReader();
  const dec = new TextDecoder();
  let buf = '';
  for (;;) {
    const {done, value} = await reader.read();
    if (done) break;
    buf += dec.decode(value, {stream: true});
    const lines = buf.split('\\n'); buf = lines.pop();
    for (const line of lines) {
      if (!line.trim()) continue;
      const ev = JSON.parse(line);
      if (panes[ev.tenant]) panes[ev.tenant].textContent = ev.text;
    }
  }
}
document.getElementById('send').onclick = send;
document.getElementById('prompt').addEventListener('keydown',
  e => { if (e.key === 'Enter') send(); });
init();
</script></body></html>
"""
