"""The dashboard (port of ``mlcomp_tpu/server/front.py``): one
dependency-free HTML page (vanilla JS + inline SVG) that the API serves
at ``GET /`` and ``/ui``, and that reads everything from the JSON API
(server/api.py).

It is the JAX package's page, but for the one comment that names the
port's ``recovery.py``: projects, dags (a layered SVG graph, config,
code browser, zip download, preflight), tasks (step tree, logs, metric
series, spans, the cross-process trace, the recovery and gang cards),
computers (usage and its history), models, logs, reports with their
layouts and galleries, the layout editor, and the supervisor tab (the
decision trace and the watchdog alerts), the serving-fleet card (the
roster, create, scale, swap and stop), and the sweep, usage and
scheduling (quotas, classes, preemptions) cards, and the SLO card
(``/api/slos``: each objective's bad fraction, burn rates and open
alert, as the supervisor's SLO engine records them).
"""

_DASHBOARD = r"""<!doctype html>
<html><head><meta charset="utf-8"><title>mlcomp_tpu</title>
<style>
:root { --bg:#101418; --panel:#1a2129; --text:#d6dde6; --dim:#7b8894;
  --acc:#4da3ff; --ok:#41c07c; --bad:#e2574c; --warn:#d9a13c; }
* { box-sizing:border-box; }
body { margin:0; background:var(--bg); color:var(--text);
  font:14px/1.45 system-ui,sans-serif; }
header { display:flex; gap:4px; align-items:center; padding:8px 14px;
  background:var(--panel); position:sticky; top:0; z-index:5; }
header h1 { font-size:16px; margin:0 18px 0 0; color:var(--acc); }
nav button { background:none; border:none; color:var(--dim); padding:6px 10px;
  cursor:pointer; font:inherit; border-radius:6px; }
nav button.active { background:var(--bg); color:var(--text); }
main { padding:14px; }
table { border-collapse:collapse; width:100%; }
th,td { text-align:left; padding:5px 10px; border-bottom:1px solid #232c36;
  vertical-align:top; }
th { color:var(--dim); font-weight:500; }
tr.row:hover { background:#1d252f; cursor:pointer; }
.status { padding:1px 8px; border-radius:9px; font-size:12px; }
.s-Success { background:#15392a; color:var(--ok); }
.s-Failed { background:#43211e; color:var(--bad); }
.s-InProgress { background:#14334d; color:var(--acc); }
.s-Queued,.s-NotRan { background:#2c2c20; color:var(--warn); }
.s-Stopped,.s-Skipped { background:#2a2f35; color:var(--dim); }
.btn { background:#232c36; color:var(--text); border:1px solid #303b46;
  border-radius:6px; padding:3px 10px; cursor:pointer; font:inherit; }
.btn:hover { border-color:var(--acc); }
pre { background:var(--panel); padding:12px; border-radius:8px;
  overflow:auto; max-height:60vh; }
.cards { display:flex; gap:12px; flex-wrap:wrap; }
.card { background:var(--panel); border-radius:10px; padding:12px 16px;
  min-width:220px; }
.card h3 { margin:0 0 6px; font-size:14px; }
.dim { color:var(--dim); }
svg text { fill:var(--text); font-size:11px; }
#login { max-width:320px; margin:18vh auto; background:var(--panel);
  padding:24px; border-radius:12px; }
input,select,textarea { background:var(--bg); border:1px solid #30383b;
  color:var(--text); padding:6px 10px; border-radius:6px; font:inherit; }
input { width:100%; }
.fl { width:auto; max-width:160px; margin-right:6px; }
textarea { width:100%; min-height:300px; font:12px/1.4 monospace; }
.charts { display:grid;
  grid-template-columns:repeat(auto-fill,minmax(380px,1fr)); gap:12px; }
.tree { margin-left:16px; }
a { color:var(--acc); }
.pager { display:flex; gap:8px; align-items:center; margin:8px 0; }
.gallery { display:grid;
  grid-template-columns:repeat(auto-fill,minmax(120px,1fr)); gap:8px; }
.gallery figure { margin:0; background:var(--panel); border-radius:8px;
  padding:6px; text-align:center; }
.gallery img { max-width:100%; border-radius:4px; image-rendering:pixelated; }
.gallery figcaption { font-size:11px; color:var(--dim); }
.cm td { padding:2px 6px; text-align:right; cursor:pointer;
  border:1px solid #232c36; }
.cm td.diag { color:var(--ok); }
.cm td.hot { color:var(--bad); }
.cm th { padding:2px 6px; text-align:right; }
.panel { margin-bottom:14px; }
.panel > h3 { cursor:pointer; user-select:none; }
dialog { background:var(--panel); color:var(--text); border:1px solid
  #303b46; border-radius:10px; min-width:420px; }
dialog::backdrop { background:#000a; }
.formrow { margin:8px 0; }
.formrow label { display:block; color:var(--dim); font-size:12px; }
</style></head><body>
<header><h1>mlcomp_tpu</h1><nav id="nav"></nav>
 <span style="flex:1"></span><span id="clock" class="dim"></span></header>
<main id="main"></main>
<dialog id="dlg"></dialog>
<script>
'use strict';
const TABS = ['projects','dags','tasks','computers','models','logs',
  'reports','layouts','supervisor'];
let tab = location.hash.replace('#','') || 'dags';
if (!TABS.includes(tab)) tab = 'dags';
let detail = null;          // {kind:'dag'|'task'|'report', id}
let token = localStorage.getItem('token') || '';
const PAGE = 25;
const pg = {};              // per-key page number
const flt = {};             // per-key filter object
const galleryState = {};    // per-gallery {page, y, y_pred, part}

async function api(path, data) {
  data = data || {};
  if (!data.paginator)
    data.paginator = {page_number:0, page_size:100};
  const r = await fetch('/api/' + path, {method:'POST',
    headers:{'Content-Type':'application/json','Authorization':token},
    body: JSON.stringify(data)});
  if (r.status === 401) { token=''; render(); throw new Error('auth'); }
  return r.json();
}
function h(html) { const t=document.createElement('template');
  t.innerHTML=html.trim(); return t.content; }
function esc(s) { return String(s==null?'':s).replace(/[&<>"']/g,
  c=>({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',
       "'":'&#39;'}[c])); }
function badge(s) { return `<span class="status s-${s}">${s}</span>`; }
function paginator(key) {
  return {page_number: pg[key]||0, page_size: PAGE};
}
function pagerHtml(key, total) {
  const p = pg[key]||0, pages = Math.max(1, Math.ceil(total/PAGE));
  return `<div class="pager">
    <button class="btn" ${p?'':'disabled'}
      onclick="pg['${key}']=${p-1};render()">&larr;</button>
    <span class="dim">page ${p+1}/${pages} &middot; ${total} rows</span>
    <button class="btn" ${p+1<pages?'':'disabled'}
      onclick="pg['${key}']=${p+1};render()">&rarr;</button></div>`;
}
function filterInput(key, field, placeholder) {
  const v = (flt[key]||{})[field]||'';
  return `<input class="fl" placeholder="${placeholder}" value="${esc(v)}"
    onchange="(flt['${key}'] ||= {})['${field}']=this.value;
              pg['${key}']=0;render()">`;
}

function nav() {
  document.getElementById('nav').innerHTML = TABS.map(t =>
    `<button class="${t===tab?'active':''}" onclick="go('${t}')">${t}</button>`
  ).join('');
}
function go(t) { tab=t; detail=null; location.hash=t; render(); }
function open_(kind,id) { detail={kind,id}; render(); }

// --------------------------------------------------------------- dialogs
function dialog(title, bodyHtml, onOk) {
  const d = document.getElementById('dlg');
  d.innerHTML = `<h3>${esc(title)}</h3>${bodyHtml}
    <div style="margin-top:12px;text-align:right">
    <button class="btn" onclick="dlgCancel()">cancel</button>
    <button class="btn" id="dlgok">ok</button></div>`;
  d.querySelector('#dlgok').onclick = async () => {
    try { await onOk(d); d.close(); render(); }
    catch (e) { alert(e.message||e); }
  };
  d.showModal();
}
function dlgCancel() { document.getElementById('dlg').close(); }
function fval(d, id) { return d.querySelector('#'+id).value.trim(); }

// ------------------------------------------------------------ tab views
async function viewProjects(el) {
  const res = await api('projects',
    {...(flt.projects||{}), paginator: paginator('projects')});
  el.appendChild(h(`<div class="pager">
    ${filterInput('projects','name','name filter')}
    <button class="btn" onclick="projectAdd()">+ project</button></div>`));
  el.appendChild(h(`<table><tr><th>id</th><th>name</th><th>dags</th>
    <th>task statuses</th><th>classes</th><th>last activity</th><th></th></tr>`
    + res.data.map(p => `<tr>
      <td>${p.id}</td><td>${esc(p.name)}</td><td>${p.dag_count}</td>
      <td>${Object.entries(p.task_statuses||{}).map(([s,c]) =>
          badge(statusName(+s))+'&times;'+c).join(' ')}</td>
      <td class="dim">${esc((p.class_names||'').slice(0,40))}</td>
      <td class="dim">${esc(p.last_activity||'')}</td>
      <td><button class="btn" onclick="projectEdit(${p.id},
          this.dataset.n)" data-n="${esc(p.name)}">edit</button>
        <button class="btn" onclick="projectRemove(${p.id})">remove</button>
      </td></tr>`).join('') + '</table>'));
  el.appendChild(h(pagerHtml('projects', res.total)));
}
function projectAdd() {
  dialog('add project', `
    <div class="formrow"><label>name</label><input id="pname"></div>
    <div class="formrow"><label>class names (yaml list, optional)</label>
      <input id="pclasses" placeholder="[cat, dog]"></div>
    <div class="formrow"><label>ignore folders (optional)</label>
      <input id="pignore" placeholder="[data, models]"></div>`,
    async d => {
      const name = fval(d,'pname');
      if (!name) throw new Error('name required');
      await api('project/add', {name, class_names: fval(d,'pclasses'),
        ignore_folders: fval(d,'pignore')});
    });
}
function projectEdit(id, name) {
  dialog('edit project '+id, `
    <div class="formrow"><label>name</label>
      <input id="pname" value="${esc(name)}"></div>
    <div class="formrow"><label>class names (yaml, blank = keep)</label>
      <input id="pclasses"></div>`,
    async d => {
      const payload = {id, name: fval(d,'pname')};
      if (fval(d,'pclasses')) payload.class_names = fval(d,'pclasses');
      await api('project/edit', payload);
    });
}
async function projectRemove(id) {
  if (!confirm('remove project '+id+'?')) return;
  await api('project/remove',{id}); render();
}

async function viewDags(el) {
  const res = await api('dags',
    {...(flt.dags||{}), paginator: paginator('dags')});
  el.appendChild(h(`<div class="pager">
    ${filterInput('dags','name','name filter')}
    ${filterInput('dags','project','project id')}</div>`));
  el.appendChild(h(`<table><tr><th>id</th><th>name</th><th>project</th>
    <th>tasks</th><th>statuses</th><th>created</th><th></th></tr>` +
    res.data.map(d => `<tr class="row" onclick="open_('dag',${d.id})">
      <td>${d.id}</td><td>${esc(d.name)}</td><td>${d.project}</td>
      <td>${d.task_count}</td>
      <td>${d.task_statuses.filter(s=>s.count)
            .map(s=>badge(s.name)+'&times;'+s.count).join(' ')}</td>
      <td class="dim">${esc(d.created||'')}</td>
      <td><button class="btn" onclick="event.stopPropagation();
        dagAction(${d.id},'stop')">stop</button>
        <button class="btn" onclick="event.stopPropagation();
        dagAction(${d.id},'start')">restart</button>
        <button class="btn" onclick="event.stopPropagation();
        dagAction(${d.id},'remove')">remove</button></td></tr>`).join('')
    + '</table>'));
  el.appendChild(h(pagerHtml('dags', res.total)));
}
async function dagAction(id, action) {
  if (action==='remove' && !confirm('remove dag '+id+'?')) return;
  await api('dag/'+action, {id}); render();
}
async function taskStop(id) { await api('task/stop',{id}); render(); }

const STATUS = ['NotRan','Queued','InProgress','Failed','Stopped',
  'Skipped','Success'];
function statusName(v) { return typeof v==='number' ? STATUS[v] : v; }

async function viewTasks(el) {
  const f = {...(flt.tasks||{})};
  if (f.status !== undefined && f.status !== '')
    f.status = [+f.status];
  else delete f.status;
  const res = await api('tasks', {...f, paginator: paginator('tasks')});
  el.appendChild(h(`<div class="pager">
    ${filterInput('tasks','name','name filter')}
    ${filterInput('tasks','dag','dag id')}
    <select class="fl" onchange="(flt.tasks ||= {}).status=this.value;
        pg.tasks=0;render()">
      <option value="">any status</option>
      ${STATUS.map((s,i)=>`<option value="${i}"
        ${(flt.tasks||{}).status==String(i)?'selected':''}>${s}</option>`)
        .join('')}
    </select></div>`));
  el.appendChild(h(`<table><tr><th>id</th><th>name</th><th>dag</th>
    <th>status</th><th>computer</th><th>step</th><th>score</th><th></th></tr>`
    + res.data.map(t => `<tr class="row" onclick="open_('task',${t.id})">
      <td>${t.id}</td><td>${esc(t.name)}</td><td>${esc(t.dag_name)}</td>
      <td>${badge(statusName(t.status))}</td>
      <td>${esc(t.computer_assigned||'')}</td>
      <td class="dim">${esc(t.current_step||'')}</td>
      <td>${t.score==null?'':t.score.toFixed(4)}</td>
      <td><button class="btn" onclick="event.stopPropagation();
        taskStop(${t.id})">stop</button>
        <button class="btn" onclick="event.stopPropagation();
        modelAddDialog(${t.id})">model</button></td></tr>`).join('')
    + '</table>'));
  el.appendChild(h(pagerHtml('tasks', res.total)));
}

function sparkline(points, key, w, hgt, color) {
  const vals = points.map(p=>p[key]).filter(v=>v!=null);
  if (vals.length < 2) return '';
  // fixed 0..100% scale so the three series share an axis and the
  // "(% of 100)" caption is true
  const step = w/(vals.length-1);
  const d = vals.map((v,i)=>(i?'L':'M')+(i*step).toFixed(1)+','
    +(hgt-Math.min(v,100)/100*hgt).toFixed(1)).join(' ');
  return `<path d="${d}" fill="none" stroke="${color}" stroke-width="1.2"/>`;
}
let computerNames = [];
async function issueWorkerToken(i) {
  const name = computerNames[i];
  if (!confirm('issue a worker token for '+name+
               '? (rotates any previous one)')) return;
  const res = await api('worker_token', {computer: name});
  prompt('WORKER_TOKEN for '+name+' (copy now — not shown again):',
         res.token);
}
async function viewComputers(el) {
  const res = await api('computers', {usage_history: true});
  computerNames = res.data.map(c => c.name);
  el.appendChild(h('<div class="cards">' + res.data.map((c, ci) => {
    const u = c.usage || {};
    const hist = c.usage_history || [];
    const spark = hist.length < 2 ? '<span class="dim">no history</span>' :
      `<svg width="260" height="40" style="margin-top:6px">
        ${sparkline(hist,'cpu',260,40,'#4da3ff')}
        ${sparkline(hist,'memory',260,40,'#41c07c')}
        ${sparkline(hist,'tpu_hbm',260,40,'#d9a13c')}</svg>
       <div class="dim" style="font-size:11px">
         <span style="color:#4da3ff">cpu</span> &middot;
         <span style="color:#41c07c">mem</span> &middot;
         <span style="color:#d9a13c">hbm</span> (% of 100, last
         ${hist.length} samples)</div>`;
    return `<div class="card"><h3>${esc(c.name)}</h3>
      <div class="dim">${c.cores||0} TPU cores &middot; ${c.cpu||0} cpu
       &middot; ${(c.memory||0).toFixed ? (c.memory||0).toFixed(1):c.memory} GB</div>
      <div>cpu ${u.cpu!=null?u.cpu.toFixed(0)+'%':'—'}
        &middot; mem ${u.memory!=null?u.memory.toFixed(0)+'%':'—'}
        &middot; hbm ${u.tpu_hbm!=null?u.tpu_hbm.toFixed(0)+'%':'—'}</div>
      ${spark}
      <div class="dim">last activity: ${esc(c.last_activity||'')}</div>
      <button class="btn" style="margin-top:6px"
        onclick="issueWorkerToken(${ci})">issue worker token</button>
      </div>`; }).join('') + '</div>'));
}

async function viewModels(el) {
  const res = await api('models',
    {...(flt.models||{}), paginator: paginator('models')});
  el.appendChild(h(`<div class="pager">
    ${filterInput('models','name','name filter')}
    <button class="btn" onclick="modelAddDialog()">+ model</button></div>`));
  el.appendChild(h(`<table><tr><th>id</th><th>name</th><th>project</th>
    <th>score local</th><th>score public</th><th>created</th><th></th></tr>` +
    res.data.map(m => `<tr><td>${m.id}</td><td>${esc(m.name)}</td>
      <td>${m.project}</td><td>${m.score_local==null?'':m.score_local}</td>
      <td>${m.score_public==null?'':m.score_public}</td>
      <td class="dim">${esc(m.created||'')}</td>
      <td><button class="btn" onclick="modelStartDialog(${m.id})">start</button>
        <button class="btn" onclick="modelRemove(${m.id})">remove</button>
      </td></tr>`).join('') + '</table>'));
  el.appendChild(h(pagerHtml('models', res.total)));
}
function modelAddDialog(taskId) {
  dialog('add model' + (taskId ? ' from task '+taskId : ''), `
    <div class="formrow"><label>model name</label><input id="mname"></div>
    <div class="formrow"><label>task id (blank = register name only)</label>
      <input id="mtask" value="${taskId||''}"></div>
    <div class="formrow"><label>project id (blank = task's project)</label>
      <input id="mproject"></div>
    <div class="formrow"><label>checkpoint file (blank = best)</label>
      <input id="mfile"></div>`,
    async d => {
      const name = fval(d,'mname');
      if (!name) throw new Error('name required');
      const payload = {name};
      if (fval(d,'mtask')) payload.task = +fval(d,'mtask');
      if (fval(d,'mproject')) payload.project = +fval(d,'mproject');
      if (fval(d,'mfile')) payload.file = fval(d,'mfile');
      if (!payload.task && !payload.project)
        throw new Error('task or project required');
      await api('model/add', payload);
    });
}
async function modelStartDialog(id) {
  const info = await api('model/start_begin', {model_id: id});
  if (!info.model) { alert('model not found'); return; }
  const pipes = info.pipes||[], versions = info.versions||[];
  dialog('start pipe for '+esc(info.model.name), `
    <div class="formrow"><label>pipe</label>
      <select id="spipe" style="width:100%">${pipes.map(p =>
        `<option>${esc(p.name)}</option>`).join('')}</select>
      ${pipes.length?'':'<span class="dim">no pipe dags in project</span>'}
    </div>
    <div class="formrow"><label>equations version</label>
      <select id="sver" style="width:100%"
        onchange="document.getElementById('seq').value=this.selectedIndex>=0
          ? this.options[this.selectedIndex].dataset.eq : ''">
        ${versions.map(v => `<option data-eq="${esc(v.equations)}">
          ${esc(v.name)}</option>`).join('')}
        <option data-eq="" ${versions.length?'':'selected'}>new</option>
      </select></div>
    <div class="formrow"><label>equations (yaml)</label>
      <textarea id="seq" style="min-height:120px">${
        esc(versions.length?versions[0].equations:'')}</textarea></div>`,
    async d => {
      if (!pipes.length) throw new Error('no pipes available');
      await api('model/start_end', {
        model_id: id, pipe: fval(d,'spipe'),
        equations: d.querySelector('#seq').value});
    });
}
async function modelRemove(id) {
  if (!confirm('remove model '+id+'?')) return;
  await api('model/remove',{id}); render();
}

async function viewLogs(el) {
  const f = {...(flt.logs||{})};
  if (f.task) f.task = +f.task; else delete f.task;
  if (!f.message) delete f.message;
  const res = await api('logs', {...f, paginator: paginator('logs')});
  el.appendChild(h(`<div class="pager">
    ${filterInput('logs','task','task id')}
    ${filterInput('logs','message','message contains')}</div>`));
  el.appendChild(h(`<table><tr><th>time</th><th>level</th><th>component</th>
    <th>computer</th><th>task</th><th>message</th></tr>` +
    res.data.map(l => `<tr><td class="dim">${esc(l.time)}</td>
      <td>${esc(l.level_name)}</td><td>${esc(l.component_name)}</td>
      <td>${esc(l.computer||'')}</td><td>${l.task||''}</td>
      <td><pre style="margin:0;max-height:120px">${esc(l.message)}</pre></td>
      </tr>`).join('') + '</table>'));
  el.appendChild(h(pagerHtml('logs', res.total)));
}

async function viewReports(el) {
  const res = await api('reports',
    {paginator: paginator('reports')});
  el.appendChild(h(`<div class="pager">
    <button class="btn" onclick="reportAdd()">+ report</button></div>`));
  el.appendChild(h(`<table><tr><th>id</th><th>name</th><th>tasks</th>
    <th>layout</th><th>time</th></tr>` +
    res.data.map(r => `<tr class="row" onclick="open_('report',${r.id})">
      <td>${r.id}</td><td>${esc(r.name)}</td><td>${r.tasks_count}</td>
      <td>${esc(r.layout||'')}</td>
      <td class="dim">${esc(r.time||'')}</td></tr>`).join('')
    + '</table>'));
  el.appendChild(h(pagerHtml('reports', res.total)));
}

async function reportAdd() {
  const info = await api('report/add_start');
  dialog('add report', `
    <div class="formrow"><label>name</label><input id="rname"></div>
    <div class="formrow"><label>project</label>
      <select id="rproject" style="width:100%">${(info.projects||[]).map(p =>
        `<option value="${p.id}">${esc(p.name)}</option>`).join('')}
      </select></div>
    <div class="formrow"><label>layout</label>
      <select id="rlay" style="width:100%">${(info.layouts||[]).map(l =>
        `<option>${esc(l)}</option>`).join('')}</select></div>`,
    async d => {
      const name = fval(d,'rname');
      if (!name) throw new Error('name required');
      await api('report/add_end', {name,
        project: +fval(d,'rproject'), layout: fval(d,'rlay')});
    });
}

let layoutNames = [];   // onclick handlers use indices, never raw names
async function viewLayouts(el) {
  const res = await api('layouts');
  layoutNames = res.data.map(l => l.name);
  const cur = flt._layoutSel;
  el.appendChild(h(`<div class="pager">
    <button class="btn" onclick="layoutAdd()">+ layout</button></div>`));
  el.appendChild(h('<div style="display:flex;gap:14px">'
    + '<table style="width:280px">'
    + '<tr><th>name</th><th>modified</th><th></th></tr>'
    + res.data.map((l,i) => `<tr class="row"
        onclick="flt._layoutSel=layoutNames[${i}];render()">
        <td>${l.name===cur?'<b>'+esc(l.name)+'</b>':esc(l.name)}</td>
        <td class="dim">${esc(l.last_modified||'')}</td>
        <td><button class="btn" onclick="event.stopPropagation();
          layoutRemove(layoutNames[${i}])">x</button></td></tr>`).join('')
    + '</table><div style="flex:1" id="layed"></div></div>'));
  const sel = res.data.find(l => l.name === cur);
  if (sel) {
    const led = el.querySelector('#layed');
    led.innerHTML = `
      <h3>${esc(sel.name)}</h3>
      <textarea id="laysrc"></textarea><br>
      <button class="btn" onclick="layoutSave(flt._layoutSel)">save</button>
      <span class="dim" id="laymsg"></span>`;
    led.querySelector('#laysrc').value = sel.content;
  }
}
function layoutAdd() {
  dialog('add layout', `
    <div class="formrow"><label>name</label><input id="lname"></div>
    <div class="formrow"><label>yaml</label>
      <textarea id="lsrc">items: {}\nlayout: []</textarea></div>`,
    async d => {
      const name = fval(d,'lname');
      if (!name) throw new Error('name required');
      await api('layout/add', {name, content: d.querySelector('#lsrc').value});
      flt._layoutSel = name;
    });
}
async function layoutSave(name) {
  const content = document.getElementById('laysrc').value;
  try {
    await api('layout/edit', {name, content});
    document.getElementById('laymsg').textContent = 'saved';
  } catch (e) { alert(e.message||e); }
}
async function layoutRemove(name) {
  if (!confirm('remove layout '+name+'?')) return;
  await api('layout/remove',{name});
  if (flt._layoutSel===name) delete flt._layoutSel;
  render();
}

async function resolveAlert(id) {
  await api('alert/resolve', {id}); render();
}
function alertsCard(alerts) {
  // watchdog findings (telemetry/watchdog.py): open alerts newest
  // first, with an ack button (auth'd resolve)
  const sevBadge = a => a.severity === 'critical'
    ? '<span class="status s-Failed">critical</span>'
    : `<span class="status"
        style="background:#3d3118;color:#d9a13c">warning</span>`;
  if (!alerts.length)
    return '<h3>alerts</h3><p class="dim">no open alerts</p>';
  return '<h3>alerts (' + alerts.length + ' open)</h3><table>'
    + '<tr><th></th><th>rule</th><th>task</th><th>computer</th>'
    + '<th>message</th><th>time</th><th></th></tr>'
    + alerts.map(a => `<tr>
      <td>${sevBadge(a)}</td><td>${esc(a.rule)}</td>
      <td>${a.task != null
        ? `<a href="#" onclick="open_('task',${a.task});return false">${a.task}</a>`
        : ''}</td>
      <td>${esc(a.computer||'')}</td><td>${esc(a.message)}</td>
      <td class="dim">${esc(a.time||'')}</td>
      <td><button class="btn" onclick="resolveAlert(${a.id})"
        >resolve</button></td></tr>`).join('') + '</table>';
}

async function fleetScale(name) {
  // serving-fleet desired-count change (server/fleet.py reconciler
  // drives actual toward it on the next supervisor tick)
  const n = prompt('desired replicas for fleet '+name+':');
  if (n == null || n === '') return;
  await api('fleet/scale', {name, desired: +n});
  render();
}

async function fleetSwap(name) {
  // zero-downtime rolling swap: generation N+1 warms, router flips,
  // N drains; failed warmup auto-rolls-back
  const model = prompt('new export model for rolling swap of '
                       +name+':');
  if (!model) return;
  await api('fleet/swap', {name, model});
  render();
}

async function fleetStop(name) {
  if (!confirm('stop fleet '+name+' (replicas drain, tasks stop)?'))
    return;
  await api('fleet/stop', {name});
  render();
}

function fleetCreateDialog() {
  dialog('create serving fleet', `
    <div class="formrow"><label>name</label>
      <input id="fname" style="width:100%"></div>
    <div class="formrow"><label>model export</label>
      <input id="fmodel" style="width:100%"></div>
    <div class="formrow"><label>replicas</label>
      <input id="freps" value="2" style="width:100%"></div>
    <div class="formrow"><label>p99 SLO (ms)</label>
      <input id="fslo" value="250" style="width:100%"></div>`,
    async d => {
      await api('fleet/create', {
        name: fval(d, 'fname'), model: fval(d, 'fmodel'),
        desired: +fval(d, 'freps') || 2,
        slo_p99_ms: +fval(d, 'fslo') || 250});
    });
}

async function viewSupervisor(el) {
  const res = await api('auxiliary');
  // db_audit needs auth while auxiliary does not — don't let a 401
  // take the whole tab down
  let audit = {data: []};
  try { audit = await api('db_audit', {limit: 50}); } catch (e) {}
  let alerts = {data: []};
  try { alerts = await api('alerts', {status: 'open'}); } catch (e) {}
  if (alerts && alerts.success === false) alerts = {data: []};
  el.appendChild(h(`<div class="pager"><button class="btn"
    onclick="if(confirm('stop worker daemons on this host?'))
      api('stop').then(render)">stop workers</button></div>`));
  // structured decision trace (reference auxiliary/supervisor page)
  const sup = (res && res.supervisor) || res || {};
  el.appendChild(h('<div>' + alertsCard(alerts.data||[]) + '</div>'));
  el.appendChild(h(`<div class="cards">
    <div class="card"><h3>tick</h3>
      <div class="dim">${esc(sup.time||'no tick yet')}</div>
      <div>${sup.duration!=null ? (sup.duration*1000).toFixed(1)+' ms'
            : ''}</div></div>
    <div class="card"><h3>live queues</h3>
      <div>${(sup.queues||[]).map(esc).join('<br>')
             || '<span class=dim>none</span>'}</div></div>
    <div class="card"><h3>runnable tasks</h3>
      <div>${(sup.tasks_to_process||[]).map(esc).join(', ')
             || '<span class=dim>none</span>'}</div></div>
  </div>`));
  if ((sup.computers||[]).length)
    el.appendChild(h('<h3>computer slots</h3><table>'
      + '<tr><th>name</th><th>cores (x=busy)</th><th>cpu</th>'
      + '<th>memory</th><th>ports in use</th></tr>'
      + sup.computers.map(c => `<tr><td>${esc(c.name)}</td>
        <td style="font-family:monospace">${esc(c.cores)}</td>
        <td>${esc(c.cpu)}</td><td>${esc(c.memory)}</td>
        <td>${esc((c.ports||[]).join(', '))}</td></tr>`).join('')
      + '</table>'));
  if ((sup.dispatched||[]).length)
    el.appendChild(h('<h3>dispatched this tick</h3><pre>'
      + esc(JSON.stringify(sup.dispatched, null, 1)) + '</pre>'));
  // model-serving endpoints (server serve --register heartbeats);
  // age_s is stamped by the API from the SERVER clock — rows past the
  // 30s liveness window render grayed as stale (crashed server), clean
  // shutdowns deregister their row entirely
  const serving = Object.entries(res||{})
    .filter(([k, v]) => k.startsWith('serving:'));
  if (serving.length)
    el.appendChild(h('<h3>serving endpoints</h3><table>'
      + '<tr><th>model</th><th>endpoint</th><th>requests</th>'
      + '<th>score</th><th>last heartbeat</th></tr>'
      + serving.map(([k, s]) => {
          const stale = s.age_s != null && s.age_s > 30;
          return `<tr${stale?' class="dim"':''}><td>${esc(s.model||k)}</td>
        <td style="font-family:monospace">${esc((s.host||'')+':'+(s.port||''))}</td>
        <td>${esc(s.requests)}</td>
        <td>${s.score==null?'':esc(s.score)}</td>
        <td class="dim">${esc(s.updated||'')}${stale
          ? ' (STALE '+esc(s.age_s)+'s)' : ''}</td></tr>`;
        }).join('')
      + '</table>'));
  // serving fleets (server/fleet.py): the self-healing replica-pool
  // tier — desired vs healthy, swap generations, respawn lineage.
  // Dead rows render dim: they are the audit trail of the healing
  let fleets = {data: []};
  try { fleets = await api('fleets'); } catch (e) {}
  if (fleets && fleets.success === false) fleets = {data: []};
  el.appendChild(h('<h3>serving fleets <button class="btn" '
    + 'onclick="fleetCreateDialog()">create fleet</button></h3>'));
  if ((fleets.data||[]).length)
    el.appendChild(h('<div class="cards">'
      + fleets.data.map(f => {
          const state = f.status === 'swapping'
            ? `swapping to g${f.target_generation}
               (${esc(f.target_model||'')})`
            : esc(f.status);
          return `<div class="card">
        <h3>${esc(f.name)} — g${f.generation} ${esc(f.model)}</h3>
        <div>${f.healthy}/${f.desired} healthy · ${state}
          · p99 SLO ${f.slo_p99_ms} ms</div>
        <div>
          <button class="btn"
            onclick="fleetScale('${esc(f.name)}')">scale</button>
          <button class="btn"
            onclick="fleetSwap('${esc(f.name)}')">swap</button>
          <button class="btn"
            onclick="fleetStop('${esc(f.name)}')">stop</button>
        </div>
        <table><tr><th>replica</th><th>gen</th><th>state</th>
          <th>computer</th><th>endpoint</th><th>reason</th></tr>
        ${(f.replicas||[]).map(r => `<tr${r.state==='dead'
            ? ' class="dim"' : ''}>
          <td>${r.id}${r.respawned_from
            ? ' <span class="dim">replaces '+r.respawned_from+'</span>'
            : ''}</td>
          <td>${r.generation}</td><td>${esc(r.state)}</td>
          <td>${esc(r.computer||'')}</td>
          <td style="font-family:monospace">${esc(r.url||'')}</td>
          <td>${esc(r.failure_reason||'')}</td></tr>`).join('')}
        </table></div>`;
        }).join('') + '</div>'));
  // ASHA sweeps (server/sweep.py): the rung ladder + per-cell verdict
  // audit — why each pruned cell was killed (rung, score, cutoff).
  // Pruned rows render dim: they are the sweep working as intended.
  let sweeps = {data: []};
  try { sweeps = await api('sweeps', {all: true}); } catch (e) {}
  if (sweeps && sweeps.success === false) sweeps = {data: []};
  if ((sweeps.data||[]).length) {
    el.appendChild(h('<h3>sweeps (ASHA early stopping)</h3>'));
    el.appendChild(h('<div class="cards">'
      + sweeps.data.map(sw => {
          const ladder = (sw.rungs||[]).map(r =>
            `rung ${r.rung}: ${r.promoted}&#9650; ${r.pruned}&#9660;`)
            .join(' · ') || 'no rungs judged yet';
          const best = sw.best_task != null
            ? ` · best cell ${sw.best_task} (${sw.best_score})` : '';
          return `<div class="card">
        <h3>${esc(sw.name)} [${esc(sw.status)}]</h3>
        <div>${esc(sw.metric)}/${esc(sw.mode)} · eta ${sw.eta}
          · rungs at ${sw.rung_base}&times;eta^r ${esc(sw.unit)}
          ${best}</div>
        <div class="dim">${ladder}</div>
        <table><tr><th>cell</th><th>status</th><th>score</th>
          <th>verdict</th></tr>
        ${(sw.cells||[]).map(c => {
          const d = (c.decisions||[]).filter(
            x => x.verdict === 'prune')[0];
          const verdict = d
            ? `pruned rung ${d.rung} (${d.score} vs ${d.cutoff})`
            : (c.decisions||[]).length
              ? `promoted through rung ${Math.max(...c.decisions
                  .map(x => x.rung))}` : '';
          return `<tr${(c.pruned || d) ? ' class="dim"' : ''}>
          <td><a href="#task/${c.task}">${c.task}</a>
            ${esc(c.name)}</td>
          <td>${esc(c.status)}</td>
          <td>${c.score == null ? '' : esc(c.score)}</td>
          <td>${verdict}</td></tr>`;
        }).join('')}
        </table></div>`;
        }).join('') + '</div>'));
  }
  // SLO scoreboard (telemetry/slo.py): every objective the burn-rate
  // engine evaluates — latest bad fraction, fast/slow burn, and the
  // open alert while burning. Burning rows render with the severity.
  let slos = {data: []};
  try { slos = await api('slos'); } catch (e) {}
  if (slos && slos.success === false) slos = {data: []};
  if ((slos.data||[]).length) {
    el.appendChild(h('<h3>SLOs (burn rates)</h3>'));
    el.appendChild(h('<div class="card"><table>'
      + '<tr><th>objective</th><th>status</th><th>bad</th>'
      + '<th>burn 5m</th><th>burn 6h</th><th>alert</th></tr>'
      + slos.data.map(o => `<tr${o.status==='ok' ? '' :
          ' style="color:' + (o.status==='critical'
            ? 'var(--bad,#e66)' : 'var(--warn,#ea3)') + '"'}>
        <td>${esc(o.key)}</td><td>${esc(o.status)}</td>
        <td>${o.bad==null?'':esc(o.bad)}</td>
        <td>${o.burn_fast==null?'':esc(o.burn_fast)}</td>
        <td>${o.burn_slow==null?'':esc(o.burn_slow)}</td>
        <td class="dim">${o.alert?esc(o.alert.message||''):''}</td>
        </tr>`).join('') + '</table></div>'));
  }
  // usage ledger (migration v14): per-tenant core-seconds + wait +
  // peak HBM, folded exactly once per terminal attempt
  let usage = {data: {totals: [], recent: []}};
  try { usage = await api('usage', {group_by: 'owner'}); } catch (e) {}
  if (usage && usage.success === false)
    usage = {data: {totals: [], recent: []}};
  const ut = (usage.data && usage.data.totals) || [];
  if (ut.length) {
    el.appendChild(h('<h3>usage (core-seconds by owner)</h3>'));
    el.appendChild(h('<div class="card"><table>'
      + '<tr><th>owner</th><th>tasks</th><th>core-s</th>'
      + '<th>max wait s</th><th>peak HBM</th></tr>'
      + ut.map(t => `<tr><td>${esc(t.key||'default')}</td>
        <td>${t.tasks}</td>
        <td>${(t.core_seconds||0).toFixed(1)}</td>
        <td>${t.queue_wait_s_max==null?''
              :t.queue_wait_s_max.toFixed(1)}</td>
        <td>${t.hbm_peak_bytes
              ?(t.hbm_peak_bytes/1073741824).toFixed(2)+' GiB':''}</td>
        </tr>`).join('') + '</table></div>'));
  }
  // scheduling card (migration v15): class roster + fair-share quota
  // bars + the newest checkpoint-preemptions with victim lineage
  let sched = {data: {quotas: [], classes: {}, preemptions: []}};
  try { sched = await api('quotas', {}); } catch (e) {}
  if (sched && sched.success === false)
    sched = {data: {quotas: [], classes: {}, preemptions: []}};
  const sd = sched.data || {};
  el.appendChild(h('<h3>scheduling (priority / quota / preemption)'
    + '</h3>'));
  let schedHtml = '<div class="cards"><div class="card"><h3>classes'
    + '</h3><table><tr><th>class</th><th>pending</th><th>running</th>'
    + '</tr>'
    + Object.entries(sd.classes || {}).map(([cls, n]) =>
      `<tr><td>${esc(cls)}</td><td>${n.pending}</td>
       <td>${n.running}</td></tr>`).join('')
    + '</table></div>';
  schedHtml += '<div class="card"><h3>quotas '
    + '<button class="btn" onclick="quotaSetDialog()">set</button>'
    + '</h3><table>'
    + '<tr><th>tenant</th><th>usage</th><th></th><th></th></tr>'
    + (sd.quotas || []).map(q => {
        const frac = q.limit > 0
          ? Math.min(1, q.used / q.limit) : (q.used > 0 ? 1 : 0);
        const color = frac >= 1 ? 'var(--bad,#e66)'
          : frac >= 0.8 ? 'var(--warn,#ea3)' : 'var(--ok,#4a4)';
        return `<tr>
          <td>${esc(q.scope)}:${esc(q.tenant)}:${esc(q.resource)}</td>
          <td>${q.used.toFixed(0)}/${q.limit.toFixed(0)}</td>
          <td><div style="width:120px;background:#0003;
              border-radius:3px"><div style="width:${
                (frac*100).toFixed(0)}%;background:${color};
              height:8px;border-radius:3px"></div></div></td>
          <td><button class="btn" onclick="quotaDelete(
            '${esc(q.scope)}','${esc(q.tenant)}','${esc(q.resource)}'
            )">remove</button></td>
          </tr>`;
      }).join('') + '</table></div>';
  if ((sd.preemptions || []).length) {
    schedHtml += '<div class="card"><h3>recent preemptions</h3>'
      + '<table><tr><th>victim</th><th>class</th><th>by</th>'
      + '<th>reason</th><th>applied</th></tr>'
      + sd.preemptions.map(p => `<tr>
          <td>${p.task} ${esc(p.task_name||'')}
            ${p.gang_id ? '<span class="dim">gang '
              + esc(p.gang_id) + '</span>' : ''}</td>
          <td>${esc(p.victim_class||'')}</td>
          <td>${p.initiator==null?'':p.initiator + ' '
            + esc(p.initiator_name||'') + ' ('
            + esc(p.initiator_class||'') + ')'}</td>
          <td>${esc(p.reason||'')}</td>
          <td>${p.applied ? 'yes'
            : '<span style="color:var(--warn,#ea3)">pending</span>'}
          </td></tr>`).join('') + '</table></div>';
  }
  el.appendChild(h(schedHtml + '</div>'));
  const np = sup.not_placed || {};
  if (Object.keys(np).length)
    el.appendChild(h('<h3>not placed (reasons)</h3><table>'
      + '<tr><th>task</th><th>reasons</th></tr>'
      + Object.entries(np).map(([tid, r]) => `<tr><td>${esc(tid)}</td>
        <td><pre style="margin:0">${esc(JSON.stringify(r))}</pre></td>
        </tr>`).join('') + '</table>'));
  el.appendChild(h('<details><summary class="dim">raw trace</summary>'
    + '<pre>'+esc(JSON.stringify(res,null,2))+'</pre></details>'));
  el.appendChild(h('<h3>db audit (proxied writes, newest first)</h3>'
    + '<table><tr><th>time</th><th>role</th><th>computer</th>'
    + '<th>op</th><th>sql</th></tr>'
    + (audit.data||[]).map(a => `<tr><td class="dim">${esc(a.time)}</td>
      <td>${esc(a.role)}</td><td>${esc(a.computer||'')}</td>
      <td>${esc(a.op)}</td>
      <td><pre style="margin:0;max-height:80px">${esc(a.sql)}</pre></td>
      </tr>`).join('') + '</table>'));
}

function quotaSetDialog() {
  // create/update a fair-share ceiling (scope owner|project,
  // resource cores|core_seconds; window only meters core_seconds)
  dialog('set quota', `
    <div class="formrow"><label>scope</label>
      <select id="qscope"><option>owner</option>
        <option>project</option></select></div>
    <div class="formrow"><label>tenant</label>
      <input id="qtenant" placeholder="default"></div>
    <div class="formrow"><label>resource</label>
      <select id="qres"><option>cores</option>
        <option>core_seconds</option></select></div>
    <div class="formrow"><label>limit</label>
      <input id="qlimit" placeholder="e.g. 16"></div>
    <div class="formrow"><label>window s</label>
      <input id="qwin" placeholder="3600 (core_seconds only)"></div>`,
    async d => {
      const body = {scope: fval(d,'qscope'), tenant: fval(d,'qtenant'),
                    resource: fval(d,'qres'),
                    limit: parseFloat(fval(d,'qlimit'))};
      const win = fval(d,'qwin');
      if (win) body.window_s = parseFloat(win);
      await api('quota/set', body);
    });
}
async function quotaDelete(scope, tenant, resource) {
  if (!confirm(`remove quota ${scope}:${tenant}:${resource}?`)) return;
  await api('quota/delete', {scope, tenant, resource}); render();
}

async function toggleReportDialog(kind, id) {
  // attach/detach a dag's train tasks (or one task) to a report
  const res = await api('reports', {paginator:{page_number:0,page_size:100}});
  dialog('toggle report for '+kind+' '+id, `
    <div class="formrow"><label>report</label>
      <select id="trep" style="width:100%">${res.data.map(r =>
        `<option value="${r.id}">${r.id}: ${esc(r.name)}</option>`).join('')}
      </select></div>
    <div class="formrow"><label><input type="checkbox" id="trem"
      style="width:auto"> remove (detach)</label></div>`,
    async d => {
      await api(kind+'/toogle_report', {id,
        report: +fval(d,'trep'),
        remove: d.querySelector('#trem').checked});
    });
}

// ---------------------------------------------------------- detail views
function layerGraph(nodes, edges) {
  // longest-path layering, then grid placement — vis.js-like output
  const level = {}; const inc = {};
  nodes.forEach(n => { level[n.id]=0; inc[n.id]=[]; });
  edges.forEach(e => inc[e.to] && inc[e.to].push(e.from));
  for (let i=0;i<nodes.length;i++)
    edges.forEach(e => { if (level[e.from]!=null && level[e.to]!=null &&
      level[e.to] < level[e.from]+1) level[e.to]=level[e.from]+1; });
  const byLevel = {};
  nodes.forEach(n => (byLevel[level[n.id]] ||= []).push(n));
  const W=190, H=74, pos={};
  Object.entries(byLevel).forEach(([lv,ns]) => ns.forEach((n,i) =>
    pos[n.id]={x:30+i*W, y:30+lv*H}));
  const width = Math.max(...Object.values(pos).map(p=>p.x))+W,
        height = Math.max(...Object.values(pos).map(p=>p.y))+H;
  const color = {Success:'#41c07c',Failed:'#e2574c',InProgress:'#4da3ff',
    Queued:'#d9a13c',NotRan:'#d9a13c',Stopped:'#7b8894',Skipped:'#7b8894'};
  let svg = `<svg width="${width}" height="${height}">`;
  edges.forEach(e => { const a=pos[e.from], b=pos[e.to]; if(!a||!b) return;
    svg += `<line x1="${a.x+70}" y1="${a.y+22}" x2="${b.x+70}" y2="${b.y}"
      stroke="${color[e.status]||'#555'}" stroke-width="1.5"
      marker-end="url(#arr)"/>`; });
  svg += `<defs><marker id="arr" markerWidth="8" markerHeight="8" refX="7"
    refY="3" orient="auto"><path d="M0,0 L7,3 L0,6" fill="none"
    stroke="#667"/></marker></defs>`;
  nodes.forEach(n => { const p=pos[n.id];
    svg += `<g onclick="open_('task',${n.id})" style="cursor:pointer">
      <rect x="${p.x}" y="${p.y}" rx="7" width="150" height="44"
        fill="#1a2129" stroke="${color[n.status]||'#555'}"/>
      <text x="${p.x+8}" y="${p.y+17}">${esc(n.label.split('\n')[0]).slice(0,20)}</text>
      <text x="${p.x+8}" y="${p.y+33}" fill="#7b8894">${n.status} #${n.id}</text>
      </g>`; });
  return svg + '</svg>';
}

function preflightCard(pf) {
  // static-analysis report (POST /api/dag/preflight): live findings
  // from the stored config+snapshot, plus what submit/dispatch recorded
  const live = (pf.errors||[]).concat(pf.warnings||[]);
  const sev = f => f.severity==='error'
    ? '<span class="status s-Failed">error</span>'
    : `<span class="status"
        style="background:#3d3118;color:#d9a13c">warning</span>`;
  const row = f => `<tr><td>${sev(f)}</td><td>${esc(f.rule)}</td>
    <td class="dim">${esc(f.path||'')}${f.line?':'+f.line:''}</td>
    <td>${esc(f.message)}</td></tr>`;
  let html = `<h3>preflight ${pf.ok
    ? '<span class="status s-Success">ok</span>'
    : '<span class="status s-Failed">failing</span>'}</h3>`;
  if (!live.length && !(pf.stored||[]).length)
    return html + '<p class="dim">no findings</p>';
  if (live.length)
    html += `<table><tr><th></th><th>rule</th><th>where</th>
      <th>message</th></tr>${live.map(row).join('')}</table>`;
  if ((pf.stored||[]).length)
    html += `<p class="dim">recorded earlier
      (${esc(pf.stored.map(s=>s.source).filter((v,i,a)=>a.indexOf(v)===i)
        .join(', '))}):</p>
      <table><tr><th></th><th>rule</th><th>where</th><th>message</th></tr>
      ${pf.stored.map(row).join('')}</table>`;
  return html;
}
async function viewDagDetail(el, id) {
  const [g, cfg, code] = await Promise.all([
    api('graph',{id}), api('config',{id}), api('code',{id})]);
  // sequential await (not in the Promise.all): the test interpreter's
  // promises are plain values with no .catch, and a failure here must
  // degrade to a note instead of killing the whole detail view
  let pf = null;
  try { pf = await api('dag/preflight',{id}); } catch(e) {}
  // a handler error resolves to {success:false,...} (api() only throws
  // on 401) — that is "report unavailable", not "preflight failing"
  if (pf && pf.success === false) pf = null;
  el.appendChild(h(`<p><a href="#" onclick="detail=null;render();return false">
    &larr; back</a> &nbsp; <b>dag ${id}</b> &nbsp;
    <a href="/api/code_download?id=${id}&token=${encodeURIComponent(token)}"
      >code.zip</a> &nbsp;
    <button class="btn" onclick="toggleReportDialog('dag',${id})"
      >toggle report</button>
    <button class="btn" onclick="if(confirm('delete report images of '+
      'dag ${id}?')) api('remove_imgs',{dag:${id}}).then(render)"
      >remove imgs</button>
    <button class="btn" onclick="if(confirm('delete stored code files '+
      'of dag ${id}?')) api('remove_files',{dag:${id}}).then(render)"
      >remove files</button></p>`));
  el.appendChild(h('<div class="card" style="overflow:auto" id="dagraph">'
    + layerGraph(g.nodes, g.edges) + '</div>'));
  el.appendChild(h('<div>'+(pf ? preflightCard(pf) :
    '<h3>preflight</h3><p class="dim">report unavailable</p>')+'</div>'));
  el.appendChild(h('<h3>config</h3><pre>'+esc(cfg.data)+'</pre>'));
  const tree = (items) => '<div class="tree">' + items.map(it =>
    it.children.length ? `<div>&#128193; ${esc(it.name)}${tree(it.children)}</div>`
    : `<div>&#128196; <a href="#" onclick="showCode(this.dataset.c);return false"
        data-c="${esc(encodeURIComponent(it.content||''))}">${esc(it.name)}</a></div>`
  ).join('') + '</div>';
  el.appendChild(h('<h3>code</h3>' + tree(code.items) +
    '<pre id="codeview" class="dim">select a file…</pre>'));
}
function showCode(c) {
  document.getElementById('codeview').textContent = decodeURIComponent(c);
}

function performanceCard(series) {
  // step attribution + recompile timeline (telemetry/attribution.py,
  // telemetry/compile_events.py): latest per-phase breakdown bar,
  // pipeline efficiency / recompile / host-sync top-lines — why the
  // step is slow, next to the trace waterfall that shows where the
  // task's wall-clock went
  const phases = ['data_wait','h2d','compute','telemetry'];
  const colors = {data_wait:'#d9a13c', h2d:'#b07fe8',
                  compute:'#41c07c', telemetry:'#4da3ff'};
  const last = n => { const pts = series[n]||[];
    return pts.length ? pts[pts.length-1].value : null; };
  const vals = {};
  let total = 0;
  phases.forEach(p => { const v = last('step.phase.'+p+'_ms');
    if (v != null) { vals[p] = v; total += v; } });
  const eff = last('step.pipeline_efficiency');
  const compiles = series['compile.backend_ms']||[];
  const syncs = (series['host_sync.suspect_ms']||[]).length;
  if (!total && eff == null && !compiles.length && !syncs) return '';
  let html = '<h3>performance</h3><div class="card">'
    + '<div style="display:flex;gap:18px;margin-bottom:8px">';
  if (eff != null)
    html += `<div><b>${(eff*100).toFixed(1)}%</b>
      <span class="dim">pipeline efficiency</span></div>`;
  html += `<div><b>${compiles.length}</b>
    <span class="dim">recompiles</span></div>`;
  if (syncs)
    html += `<div><b>${syncs}</b>
      <span class="dim">host-sync suspects</span></div>`;
  html += '</div>';
  if (total) {
    html += '<div style="display:flex;height:16px;border-radius:4px;'
      + 'overflow:hidden">'
      + phases.filter(p => vals[p] != null).map(p =>
        `<span title="${p}" style="width:${
          (vals[p]/total*100).toFixed(2)}%;background:${
          colors[p]}"></span>`).join('')
      + '</div>'
      + '<div class="dim" style="font-size:11px;margin-top:4px">'
      + phases.filter(p => vals[p] != null).map(p =>
        `<span style="color:${colors[p]}">${p}</span> ${
          vals[p].toFixed(2)} ms`).join(' &middot; ')
      + ' (latest step)</div>';
  }
  if (compiles.length)
    html += '<div class="dim" style="font-size:11px;margin-top:6px">'
      + 'recompile timeline: '
      + compiles.slice(-8).map(p => 'step '
        + (p.step == null ? '?' : p.step) + ': '
        + (+p.value).toFixed(0) + ' ms').join(' &middot; ')
      + '</div>';
  return html + '</div>';
}

function memoryCard(series) {
  // HBM timeline + compiled-peak attribution (telemetry/memory.py):
  // latest used/limit/peak per device as occupancy bars, plus the
  // static peak split (arguments/outputs/temps/code) from the
  // compiled executable's memory_analysis — how close am I, and what
  // would I have to shrink
  const last = n => { const pts = series[n]||[];
    return pts.length ? pts[pts.length-1] : null; };
  const devs = [];
  Object.keys(series).forEach(n => {
    if (n.slice(0,6) === 'device' && n.slice(-9) === '.hbm_used')
      devs.push(n.slice(6, n.length-9));
  });
  const rows = [];
  let worst = null;
  devs.forEach(d => {
    const used = last('device'+d+'.hbm_used');
    const lim = last('device'+d+'.hbm_limit');
    const peak = last('device'+d+'.hbm_peak');
    if (!used || !lim || !lim.value) return;
    const occ = used.value / lim.value;
    if (worst == null || occ > worst) worst = occ;
    rows.push({d:d, used:used.value, lim:lim.value,
               peak: peak ? peak.value : null, occ:occ});
  });
  const attr = last('memory.attribution');
  if (!rows.length && !attr) return '';
  const gb = v => (v/1e9).toFixed(2);
  let html = '<h3>memory</h3><div class="card">';
  if (worst != null)
    html += `<div style="margin-bottom:8px"><b>${
      (worst*100).toFixed(1)}%</b>
      <span class="dim">worst HBM occupancy (latest sample)</span></div>`;
  rows.forEach(r => {
    const pct = r.occ > 1 ? 100 : r.occ*100;
    html += `<div class="dim" style="font-size:11px">device ${r.d}:
      ${gb(r.used)} / ${gb(r.lim)} GB`
      + (r.peak ? ` (peak ${gb(r.peak)})` : '') + '</div>'
      + '<div style="height:8px;background:#2a2f3a;border-radius:4px;'
      + 'margin:2px 0 6px">'
      + `<div style="height:8px;width:${pct.toFixed(1)}%;`
      + `border-radius:4px;background:${
        r.occ > 0.92 ? '#e05d5d' : '#41c07c'}"></div></div>`;
  });
  if (attr && attr.tags) {
    const parts = ['argument_bytes','output_bytes','temp_bytes',
                   'generated_code_bytes']
      .filter(k => attr.tags[k])
      .map(k => k.replace('_bytes','') + ' ' + gb(attr.tags[k]) + ' GB');
    if (parts.length)
      html += '<div class="dim" style="font-size:11px">compiled peak: '
        + parts.join(' &middot; ') + '</div>';
  }
  return html + '</div>';
}

function commCard(series) {
  // collective-communication attribution (telemetry/collectives.py):
  // the measured comm share of the step, the per-device collective
  // bytes the compiled HLO moves, and the per-op tally — is this
  // step math-bound or network-bound, next to the phase breakdown
  const last = n => { const pts = series[n]||[];
    return pts.length ? pts[pts.length-1] : null; };
  const frac = last('comm.fraction');
  const total = last('comm.bytes_per_step');
  const probe = last('comm.probe_ms');
  const ops = [];
  Object.keys(series).forEach(n => {
    if (n.slice(0,5) === 'comm.' && n.slice(-6) === '_bytes'
        && n !== 'comm.bytes_per_step') {
      const op = n.slice(5, n.length-6);
      const count = last('comm.'+op+'_count');
      ops.push({op:op, bytes:last(n).value,
                count: count ? count.value : null});
    }
  });
  if (!frac && !total && !ops.length) return '';
  let html = '<h3>communication</h3><div class="card">'
    + '<div style="display:flex;gap:18px;margin-bottom:8px">';
  if (frac)
    html += `<div><b>${(frac.value*100).toFixed(1)}%</b>
      <span class="dim">measured comm share of step</span></div>`;
  if (total)
    html += `<div><b>${(total.value/1e6).toFixed(1)} MB</b>
      <span class="dim">collective bytes / device / step</span></div>`;
  if (probe)
    html += `<div><b>${probe.value.toFixed(2)} ms</b>
      <span class="dim">wire probe</span></div>`;
  html += '</div>';
  if (ops.length)
    html += '<div class="dim" style="font-size:11px">'
      + ops.map(o => o.op + ': ' + (o.bytes/1e6).toFixed(1) + ' MB'
        + (o.count != null ? ' &times; ' + o.count : ''))
        .join(' &middot; ')
      + '</div>';
  return html + '</div>';
}

function devtimeCard(dt) {
  // sampled device-time attribution (telemetry/deviceprof.py +
  // POST /api/task/devtime): where the newest trace window's device
  // time went — compute / exposed collectives / infeed-outfeed /
  // idle — plus the exposed-comm trend across windows that the
  // watchdog's exposed-comm-regression rule judges
  if (!dt || dt.success === false || !dt.summary) return '';
  const s = dt.summary, b = s.buckets || {};
  const total = (b.compute_ms||0) + (b.comm_exposed_ms||0)
    + (b.io_ms||0) + (b.idle_ms||0);
  if (!total) return '';
  let html = '<h3>device time</h3><div class="card">'
    + '<div style="display:flex;gap:18px;margin-bottom:8px">'
    + `<div><b>${((s.busy_frac||0)*100).toFixed(1)}%</b>
       <span class="dim">device busy</span></div>`
    + `<div><b>${((s.exposed_comm_frac||0)*100).toFixed(1)}%</b>
       <span class="dim">exposed comm</span></div>`
    + `<div><b>${(+s.window_ms||0).toFixed(2)} ms</b>
       <span class="dim">window${s.step != null ? ' @ step '+s.step : ''}
       &times; ${s.device_lines||1} device lines</span></div>`
    + '</div>';
  // stacked bucket bar: compute + exposed comm + io + idle sum to
  // the window (comm hidden under compute rides inside the compute
  // segment by construction — the parser's bucket invariant)
  const segs = [['compute', b.compute_ms, '#41c07c'],
                ['exposed comm', b.comm_exposed_ms, '#e05d5d'],
                ['io', b.io_ms, '#5d9de0'],
                ['idle', b.idle_ms, '#565d6b']];
  html += '<div style="display:flex;height:10px;border-radius:4px;'
    + 'overflow:hidden;margin:2px 0 4px;background:#2a2f3a">'
    + segs.map(([n, v, c]) =>
      `<div title="${n} ${(v||0).toFixed(2)} ms" style="width:${
        (100*(v||0)/total).toFixed(1)}%;background:${c}"></div>`)
      .join('')
    + '</div><div class="dim" style="font-size:11px">'
    + segs.map(([n, v, c]) => `<span style="color:${c}">&#9632;</span>
        ${n} ${(100*(v||0)/total).toFixed(1)}%`).join(' &middot; ')
    + '</div>';
  const ops = s.ops || [];
  if (ops.length)
    html += '<div class="dim" style="font-size:11px;margin-top:6px">'
      + ops.slice(0,6).map(o =>
          esc(o.op) + ' ' + (+o.ms).toFixed(2) + ' ms'
          + (o.count ? ' &times; ' + o.count : '')).join(' &middot; ')
      + '</div>';
  const trend = ((dt.series||{})['devtime.exposed_comm_frac']||[])
    .filter(p => p.step != null);
  if (trend.length >= 2)
    html += '<div class="charts">' + lineChart(
      'devtime.exposed_comm_frac', 'step',
      trend.map(p => ({epoch: p.step, value: p.value}))) + '</div>';
  return html + '</div>';
}

function postmortemCard(pm) {
  // the flight recorder's frozen bundle (telemetry/memory.py,
  // POST /api/task/postmortem): the at-death explanation of a failed
  // task — reason, when, and which series the bundle carries
  if (!pm || pm.success === false || !pm.task) return '';
  let html = '<h3>postmortem</h3><div class="card">'
    + '<div style="display:flex;gap:18px;margin-bottom:8px">'
    + `<div><b>${esc(pm.reason || '?')}</b>
       <span class="dim">reason</span></div>`
    + `<div><b>${esc(pm.created || '')}</b>
       <span class="dim">frozen at</span></div>`;
  const card = pm.task_card || {};
  if (card.computer)
    html += `<div><b>${esc(card.computer)}</b>
      <span class="dim">computer</span></div>`;
  html += '</div>';
  const names = Object.keys(pm.series || {});
  if (names.length)
    html += '<div class="dim" style="font-size:11px">'
      + names.map(n => {
          const pts = pm.series[n];
          return esc(n) + ': ' + pts.length + ' pts, last '
            + (+pts[pts.length-1].value).toPrecision(4);
        }).join(' &middot; ') + '</div>';
  return html + '</div>';
}

function recoveryCard(info, series) {
  // automatic-recovery history (mlcomp_tpu_torch/recovery.py): retries
  // consumed vs budget, the taxonomy verdict of the last failure, the
  // scheduled next retry, and the per-event task.retry timeline the
  // supervisor writes on each requeue
  const events = series['task.retry'] || [];
  if (!(info.attempt) && !events.length && !info.failure_reason)
    return '';
  let html = '<h3>recovery</h3><div class="card">'
    + '<div style="display:flex;gap:18px;margin-bottom:8px">'
    + `<div><b>${info.attempt || 0}${info.max_retries != null
        ? '/' + info.max_retries : ''}</b>
       <span class="dim">retries used</span></div>`;
  if (info.failure_reason)
    html += `<div><b>${esc(info.failure_reason)}</b>
      <span class="dim">last failure</span></div>`;
  if (info.next_retry_at)
    html += `<div><b>${esc(info.next_retry_at)}</b>
      <span class="dim">next retry</span></div>`;
  html += '</div>';
  if (events.length)
    html += '<div class="dim" style="font-size:11px">'
      + events.map(p => 'retry ' + (p.step == null ? '?' : p.step)
        + (p.tags && p.tags.reason ? ' (' + esc(p.tags.reason) + ')' : '')
        + ' at ' + esc(p.time || '')).join(' &middot; ')
      + '</div>';
  return html + '</div>';
}

function gangCard(info, series) {
  // elastic gang-atomic recovery (server/supervisor.py): the gang a
  // multi-host job belongs to, which generation is live (each
  // gang-abort + requeue bumps it — possibly onto fewer hosts with a
  // reshaped mesh), the per-rank roster, and the generation-bump
  // event timeline the supervisor records as gang.generation rows
  if (!info.gang_id) return '';
  const bumps = series['gang.generation'] || [];
  let html = '<h3>gang</h3><div class="card">'
    + '<div style="display:flex;gap:18px;margin-bottom:8px">'
    + `<div><b>${esc(info.gang_id)}</b>
       <span class="dim">gang</span></div>`
    + `<div><b>${info.gang_generation || 1}</b>
       <span class="dim">generation</span></div>`;
  if ((info.gang_ranks || []).length)
    html += `<div><b>${info.gang_ranks.length}</b>
       <span class="dim">ranks</span></div>`;
  html += '</div>';
  if ((info.gang_ranks || []).length)
    html += '<table><tr><th>rank</th><th>task</th><th>status</th>'
      + '<th>computer</th><th>reason</th></tr>'
      + info.gang_ranks.map(r => `<tr>
        <td>${r.rank == null ? '?' : r.rank}</td>
        <td>${r.task}</td>
        <td><span class="status s-${esc(r.status)}">${esc(r.status)}
          </span></td>
        <td class="dim">${esc(r.computer || '')}</td>
        <td class="dim">${esc(r.failure_reason || '')}</td>
        </tr>`).join('') + '</table>';
  if (bumps.length)
    html += '<div class="dim" style="font-size:11px;margin-top:6px">'
      + bumps.map(p => 'generation '
        + (p.step == null ? '?' : p.step)
        + (p.tags && p.tags.reason ? ' (' + esc(p.tags.reason) + ')' : '')
        + ' at ' + esc(p.time || '')).join(' &middot; ')
      + '</div>';
  return html + '</div>';
}

async function profileToggle(id, action) {
  // on-demand jax.profiler trace on a RUNNING task; the training
  // process polls the request at epoch boundaries
  const res = await api('telemetry/profile', {task:id, action});
  alert('profiler: ' + (res.status||'?') + (res.dir?' '+res.dir:''));
}

async function viewTaskDetail(el, id) {
  const [info, steps, logs, tel, perfTel, spans] = await Promise.all([
    api('task/info',{id}), api('task/steps',{id}),
    api('logs',{task:id, paginator:{page_number:0,page_size:50}}),
    api('telemetry/series',{task:id}),
    // tail fetch: newest N samples of EVERY name — on long runs the
    // plain ascending-limit fetch above truncates the newest samples
    // of later-sorting names, and the performance card must show the
    // genuinely latest step, not a stale early window
    api('telemetry/series',{task:id, tail:64}),
    api('telemetry/spans',{task:id})]);
  el.appendChild(h(`<p><a href="#" onclick="detail=null;render();return false">
    &larr; back</a> &nbsp; <b>task ${id}</b> &nbsp;
    <button class="btn" onclick="toggleReportDialog('task',${id})"
      >toggle report</button>
    <button class="btn" onclick="profileToggle(${id},'start')"
      >profile</button>
    <button class="btn" onclick="profileToggle(${id},'stop')"
      >stop profile</button></p>`));
  el.appendChild(h('<pre>'+esc(JSON.stringify(info,null,2))+'</pre>'));
  // recovery card: retry history for tasks the supervisor auto-
  // requeued (or is about to) — next to the raw info so a Failed
  // task's "why" and "what happens next" read together
  const rec = recoveryCard(info, tel.series || {});
  if (rec) el.appendChild(h('<div>' + rec + '</div>'));
  // gang card: multi-host identity + generation + rank roster, next
  // to the recovery card that explains WHY a generation was bumped
  const gang = gangCard(info, tel.series || {});
  if (gang) el.appendChild(h('<div>' + gang + '</div>'));
  const tree = (nodes) => '<div class="tree">' + nodes.map(s =>
    `<div>&#9656; ${esc(s.name)} <span class="dim">${esc(s.started||'')}
     ${s.finished?'&rarr; '+esc(s.finished):''}</span>
     ${s.log_statuses.filter(x=>x.count).map(x=>x.name+':'+x.count).join(' ')}
     ${tree(s.children)}</div>`).join('') + '</div>';
  el.appendChild(h('<h3>steps</h3>' + tree(steps.data)));
  // per-step metric series recorded from inside the train loop
  // (telemetry/): stepped series chart like report series, scalar
  // gauges/counters as a compact latest-value table
  const series = tel.series || {};
  const stepped = [], scalars = [];
  Object.keys(series).forEach(n => {
    const pts = series[n].filter(p => p.step != null);
    if (pts.length >= 2) stepped.push([n, pts]);
    else scalars.push([n, series[n][series[n].length-1]]);
  });
  if (stepped.length)
    el.appendChild(h('<h3>telemetry series</h3><div class="charts">'
      + stepped.map(([n, pts]) => lineChart(n, 'step',
          pts.map(p => ({epoch: p.step, value: p.value})))).join('')
      + '</div>'));
  if (scalars.length)
    el.appendChild(h('<h3>telemetry gauges</h3><table>'
      + '<tr><th>metric</th><th>last value</th><th>kind</th>'
      + '<th>time</th></tr>'
      + scalars.map(([n, p]) => `<tr><td>${esc(n)}</td>
        <td>${p && p.value!=null ? (+p.value).toPrecision(6) : ''}</td>
        <td class="dim">${esc(p ? p.kind : '')}</td>
        <td class="dim">${esc(p ? p.time||'' : '')}</td></tr>`).join('')
      + '</table>'));
  // performance card: phase breakdown + recompile timeline for the
  // selected task (telemetry attribution + compile events), from the
  // tail fetch so 'latest step' is true however long the run
  const perf = performanceCard(perfTel.series || {});
  if (perf) el.appendChild(h('<div>' + perf + '</div>'));
  // memory + communication cards beside the phase breakdown: the HBM
  // timeline / compiled-peak attribution and the measured collective
  // share (telemetry/memory.py, telemetry/collectives.py)
  const mem = memoryCard(perfTel.series || {});
  if (mem) el.appendChild(h('<div>' + mem + '</div>'));
  const comm = commCard(perfTel.series || {});
  if (comm) el.appendChild(h('<div>' + comm + '</div>'));
  // device-time card: the sampled trace windows' attribution
  // (telemetry/deviceprof.py — 404s quietly when the engine never
  // sampled this task, e.g. CPU runs with the cadence defaulted off)
  let dt = null;
  try { dt = await api('task/devtime', {task: id, tail: 32}); }
  catch (e) {}
  const dtc = devtimeCard(dt);
  if (dtc) el.appendChild(h('<div>' + dtc + '</div>'));
  // postmortem card for failed tasks: the flight recorder's frozen
  // at-death bundle (404s quietly when the task never failed with a
  // taxonomy reason)
  if (info.failure_reason) {
    let pm = null;
    try { pm = await api('task/postmortem', {task: id}); }
    catch (e) {}
    const pmc = postmortemCard(pm);
    if (pmc) el.appendChild(h('<div>' + pmc + '</div>'));
  }
  // span forest: where the task's wall-clock went (worker pipeline
  // phases + executor internals), durations in ms
  const spanTree = nodes => '<div class="tree">' + nodes.map(s =>
    `<div>&#9656; ${esc(s.name)}
     <span class="dim">${(s.duration*1000).toFixed(1)} ms</span>
     ${s.status==='error' ? '<span class="status s-Failed">error</span>' : ''}
     ${s.tags ? '<span class="dim">'+esc(JSON.stringify(s.tags))+'</span>' : ''}
     ${spanTree(s.children||[])}</div>`).join('') + '</div>';
  if ((spans.spans||[]).length)
    el.appendChild(h('<h3>telemetry spans</h3>' + spanTree(spans.spans)));
  // cross-process trace waterfall: this task's spans carry the trace
  // id minted at DAG submission — the assembled view shows the
  // supervisor dispatch, worker pipeline and train-loop legs on one
  // wall-clock axis (GET /telemetry/trace/<id>)
  const traceId = (spans.spans||[]).map(s => s.trace_id)
    .filter(t => t)[0];
  if (traceId) {
    let tr = null;
    try { tr = await api('telemetry/trace', {id: traceId}); }
    catch (e) {}
    if (tr && tr.success !== false && (tr.spans||[]).length)
      el.appendChild(h('<h3>trace <span class="dim">' + esc(traceId)
        + '</span></h3>' + traceWaterfall(tr)));
  }
  el.appendChild(h('<h3>logs</h3><table>' + logs.data.map(l =>
    `<tr><td class="dim">${esc(l.time)}</td><td>${esc(l.level_name)}</td>
     <td><pre style="margin:0">${esc(l.message)}</pre></td></tr>`).join('')
    + '</table>'));
}

function traceWaterfall(tr) {
  // one row per span across EVERY process of the trace, positioned on
  // the shared wall-clock axis; bar color = process role
  const t0 = tr.started || 0;
  const total = Math.max((tr.finished||t0) - t0, 1e-6);
  const rows = [];
  const walk = (nodes, depth) => nodes.forEach(n => {
    rows.push({n: n, depth: depth});
    walk(n.children||[], depth+1);
  });
  walk(tr.spans||[], 0);
  const roleColor = {supervisor:'#d9a13c', worker:'#4da3ff',
                     train:'#41c07c'};
  const bar = r => {
    const n = r.n;
    const left = Math.max(0, (n.started - t0)/total*100);
    const width = Math.max(0.4,
      Math.min((n.duration||0)/total*100, 100-left));
    const color = roleColor[n.process_role] || '#7b8894';
    return `<div style="display:flex;align-items:center;gap:8px;
        font-size:12px;margin:1px 0">
      <span style="width:250px;overflow:hidden;white-space:nowrap;
        padding-left:${r.depth*12}px">${esc(n.name)}
        <span class="dim">${esc(n.process_role||'')}</span></span>
      <span style="flex:1;position:relative;height:14px;
        background:#101418;border-radius:3px">
        <span style="position:absolute;left:${left.toFixed(2)}%;
          width:${width.toFixed(2)}%;top:2px;bottom:2px;
          background:${color};border-radius:2px"></span></span>
      <span class="dim" style="width:90px;text-align:right">
        ${((n.duration||0)*1000).toFixed(1)} ms</span></div>`;
  };
  return '<div class="card" style="min-width:680px">'
    + rows.map(bar).join('')
    + `<div class="dim" style="font-size:11px;margin-top:6px">
       ${tr.span_count} spans &middot;
       ${(tr.processes||[]).length} process(es) &middot;
       <span style="color:#d9a13c">supervisor</span> &middot;
       <span style="color:#4da3ff">worker</span> &middot;
       <span style="color:#41c07c">train</span> &middot;
       ${(total*1000).toFixed(1)} ms total</div></div>`;
}

// per-chart zoom windows survive re-renders (keyed by series name);
// chartData is rebuilt every render and onclick/onmouseover handlers
// reference charts by numeric index — no user string ever lands in
// generated JS (the gallery-key convention)
const chartState = {};      // key -> {lo, hi} epoch window
let chartData = [];

function chartHover(ci, si, j) {
  const c = chartData[ci]; if (!c) return;
  const p = (c.series[si]||[])[j]; if (!p) return;
  const el = document.getElementById('chr'+ci);
  if (el) el.textContent = c.names[si] + '  epoch ' + p.epoch +
    ': ' + (+p.value).toPrecision(5);
}

function chartZoom(ci, dir) {
  const c = chartData[ci]; if (!c) return;
  const cur = chartState[c.key] || {lo: c.x0, hi: c.x1};
  const span = Math.max(cur.hi-cur.lo, 1), mid = (cur.lo+cur.hi)/2;
  if (dir === 0) delete chartState[c.key];
  else if (dir > 0)
    chartState[c.key] = {lo: mid-span/4, hi: mid+span/4};
  else chartState[c.key] = {lo: mid-span, hi: mid+span};
  render();
}

function lineChart(name, part, points) {
  const w=360, hgt=180, pad=34;
  // key includes the open view: the same series name in two reports
  // must not share a zoom window
  const view = detail ? detail.kind + detail.id : tab;
  const key = view + '/' + name + '/' + part;
  let zoom = chartState[key];
  let pts = zoom ? points.filter(p =>
    p.epoch >= zoom.lo && p.epoch <= zoom.hi) : points;
  if (zoom && !pts.length) {
    // over-zoomed past every sample: drop the stale window instead of
    // silently showing ALL points under a narrow-window label
    delete chartState[key]; zoom = null; pts = points;
  }
  const xs = pts.map(p=>p.epoch), ys = pts.map(p=>p.value);
  const x0=Math.min(...xs), x1=Math.max(...xs,x0+1);
  const y0=Math.min(...ys), y1=Math.max(...ys,y0+1e-9);
  const X=e=>pad+(e-x0)/(x1-x0)*(w-pad-10);
  const Y=v=>hgt-pad+ (y0===y1?0:-(v-y0)/(y1-y0)*(hgt-pad-16));
  const byTask = {};
  pts.forEach(p => (byTask[p.task_name||p.task] ||= []).push(p));
  const ci = chartData.length;
  chartData.push({key, x0, x1, series: Object.values(byTask),
                  names: Object.keys(byTask)});
  const colors=['#4da3ff','#41c07c','#d9a13c','#e2574c','#b07fe8','#5bc8c8'];
  let svg = `<svg width="${w}" height="${hgt}">
    <text x="8" y="14">${esc(name)} / ${esc(part)}</text>
    <text id="chr${ci}" x="${pad+60}" y="${hgt-6}" fill="#9fb0bd"></text>
    <text x="8" y="${hgt-6}" fill="#7b8894">${y0.toPrecision(4)}..${y1.toPrecision(4)}</text>`;
  chartData[ci].series.forEach((sp,i) => {
    const d = sp.map((p,j)=>(j?'L':'M')+X(p.epoch)+','+Y(p.value)).join(' ');
    svg += `<path d="${d}" fill="none" stroke="${colors[i%6]}" stroke-width="1.6"/>`;
    // invisible hover targets, one per sample: value readout without
    // a mouse-position event object
    sp.forEach((p,j) => { svg +=
      `<circle cx="${X(p.epoch)}" cy="${Y(p.value)}" r="6"
        fill="transparent" onmouseover="chartHover(${ci},${i},${j})"/>`;
    });
  });
  return '<div class="card">'+svg+'</svg>' +
    `<div><button class="btn" onclick="chartZoom(${ci},1)">zoom+</button>
     <button class="btn" onclick="chartZoom(${ci},-1)">zoom-</button>
     <button class="btn" onclick="chartZoom(${ci},0)">reset</button>
     ${zoom ? `<span class="dim">x: ${zoom.lo.toFixed(1)}..${zoom.hi.toFixed(1)}</span>` : ''}
     </div></div>`;
}

// ------------------------------------------------- layout-driven report
function gKey(reportId, source) { return reportId + ':' + source; }
// gallery keys embed layout item names (user data) — onclick handlers
// reference galleries by numeric index so no user string is ever
// interpolated into generated JS
const gKeys = [];
function gState(key) {
  return galleryState[key] ||= {page: 0, y: '', y_pred: ''};
}
function gStateI(i) { return gState(gKeys[i]); }
async function galleryHtml(kind, key, taskIds) {
  let gi = gKeys.indexOf(key);
  if (gi < 0) { gKeys.push(key); gi = gKeys.length - 1; }
  const st = gState(key);
  const filter = {paginator: {page_number: st.page, page_size: 16}};
  // only this report's tasks — the table holds every dag's images
  if (taskIds && taskIds.length) filter.tasks = taskIds;
  if (st.y !== '') filter.y = +st.y;
  if (st.y_pred !== '') filter.y_pred = +st.y_pred;
  const res = await api(kind, filter);
  let html = '';
  if (kind === 'img_classify' && res.confusion && res.confusion.n) {
    const m = res.confusion.matrix, n = res.confusion.n;
    const max = Math.max(1, ...m.flat());
    html += '<div style="display:flex;gap:18px;flex-wrap:wrap">';
    html += '<div><div class="dim">confusion (y &rarr; y_pred), click to filter</div>'
      + '<table class="cm"><tr><th></th>'
      + Array.from({length:n},(_,j)=>`<th>${j}</th>`).join('') + '</tr>'
      + m.map((row,i)=>`<tr><th>${i}</th>` + row.map((c,j)=>
        `<td class="${i===j?'diag':(c>max*0.15?'hot':'')}"
          style="background:rgba(77,163,255,${(c/max*0.55).toFixed(3)})"
          onclick="Object.assign(gStateI(${gi}),
            {y:${i},y_pred:${j},page:0});render()">${c||''}</td>`).join('')
        + '</tr>').join('') + '</table></div>';
    html += '<div style="flex:1">';
  }
  html += `<div class="pager">
    <input class="fl" style="max-width:70px" placeholder="y"
      value="${st.y}" onchange="Object.assign(gStateI(${gi}),
        {y:this.value,page:0});render()">
    <input class="fl" style="max-width:70px" placeholder="y_pred"
      value="${st.y_pred}" onchange="Object.assign(gStateI(${gi}),
        {y_pred:this.value,page:0});render()">
    <button class="btn" onclick="Object.assign(gStateI(${gi}),
      {y:'',y_pred:'',page:0});render()">clear</button>
    <button class="btn" ${st.page?'':'disabled'}
      onclick="gStateI(${gi}).page--;render()">&larr;</button>
    <span class="dim">${res.total} imgs</span>
    <button class="btn" ${(st.page+1)*16<res.total?'':'disabled'}
      onclick="gStateI(${gi}).page++;render()">&rarr;</button></div>`;
  html += '<div class="gallery">' + res.data.map(im => `
    <figure><img src="data:image/jpeg;base64,${im.img}">
      <figcaption>${im.y!=null?'y='+im.y:''}
        ${im.y_pred!=null?' &rarr; '+im.y_pred:''}
        ${im.score!=null?' ('+(+im.score).toFixed(3)+')':''}
        <br>${esc(im.part||'')} ep${im.epoch==null?'':im.epoch}
      </figcaption></figure>`).join('') + '</div>';
  if (kind === 'img_classify' && res.confusion && res.confusion.n)
    html += '</div></div>';
  return html;
}

async function viewReportDetail(el, id) {
  const res = await api('report',{id});
  el.appendChild(h(`<p><a href="#" onclick="detail=null;render();return false">
    &larr; back</a> &nbsp; <b>report ${id}</b> &nbsp;
    <button class="btn" onclick="reportLayoutDialog(${id})">layout</button></p>`));
  const layout = res.layout || {};
  const items = layout.items || {};
  const panels = layout.layout || [];
  const bySeries = {};   // series name -> [{part, data}]
  (res.series||[]).forEach(s =>
    (bySeries[s.name] ||= []).push(s));
  if (!panels.length) {
    // no layout: flat dump fallback (pre-layout behavior)
    el.appendChild(h('<div class="charts">' + (res.series||[]).map(s =>
      lineChart(s.name, s.part, s.data)).join('') + '</div>'));
    return;
  }
  for (const [pi, panel] of panels.entries()) {
    const k = '_p' + id + '_' + pi;
    const collapsed = flt[k] !== undefined ? flt[k]
      : panel.expanded === false;
    const pel = h(`<div class="panel card">
      <h3 onclick="flt['${k}'] = ${!collapsed}; render()">
        ${collapsed ? '&#9656;' : '&#9662;'}
        ${esc(panel.title||'panel')}</h3>
      <div class="body"></div></div>`);
    const body = pel.querySelector('.body');
    el.appendChild(pel);
    if (collapsed) continue;
    const charts = document.createElement('div');
    charts.className = 'charts';
    body.appendChild(charts);
    for (const item of (panel.items||[])) {
      const src = item.source || item.key;
      const spec = items[src] || {};
      const type = item.type || spec.type;
      if (type === 'series') {
        const name = spec.key || src;
        (bySeries[name]||[]).forEach(s =>
          charts.appendChild(h(lineChart(name, s.part, s.data))));
        if (!(bySeries[name]||[]).length)
          charts.appendChild(h(
            `<div class="card dim">no series '${esc(name)}'</div>`));
      } else if (type === 'img_classify' || type === 'img_segment') {
        const div = document.createElement('div');
        div.style.gridColumn = '1 / -1';
        div.innerHTML = await galleryHtml(
          type, gKey(id, src), res.tasks||[]);
        charts.appendChild(div);
      }
    }
  }
}
async function reportLayoutDialog(id) {
  const info = await api('report/update_layout_start', {id});
  dialog('report layout', `
    <div class="formrow"><label>layout
      (current: ${esc(info.current||'none')})</label>
      <select id="rlayout" style="width:100%">${(info.layouts||[]).map(l =>
        `<option ${l===info.current?'selected':''}>${esc(l)}</option>`)
        .join('')}</select></div>
    <div class="dim">edit layout yaml in the layouts tab</div>`,
    async d => {
      await api('report/update_layout_end',
        {id, layout: fval(d,'rlayout')});
    });
}

// --------------------------------------------------------------- render
const VIEWS = {projects:viewProjects, dags:viewDags, tasks:viewTasks,
  computers:viewComputers, models:viewModels, logs:viewLogs,
  reports:viewReports, layouts:viewLayouts, supervisor:viewSupervisor};

async function render() {
  nav();
  chartData = [];          // rebuilt by every lineChart this pass
  const el = document.getElementById('main');
  el.innerHTML = '';
  if (!token) {
    el.appendChild(h(`<div id="login"><h3>token</h3>
      <input id="tok" type="password" placeholder="access token">
      <br><br><button class="btn" onclick="login()">enter</button></div>`));
    return;
  }
  try {
    if (detail && detail.kind==='dag') await viewDagDetail(el, detail.id);
    else if (detail && detail.kind==='task') await viewTaskDetail(el, detail.id);
    else if (detail && detail.kind==='report') await viewReportDetail(el, detail.id);
    else await VIEWS[tab](el);
  } catch (e) {
    if (e.message !== 'auth')
      el.appendChild(h('<pre>'+esc(e.stack||e)+'</pre>'));
  }
}
async function login() {
  const t = document.getElementById('tok').value.trim();
  const r = await fetch('/api/token', {method:'POST',
    headers:{'Content-Type':'application/json'},
    body: JSON.stringify({token:t})});
  if (r.ok) { token=t; localStorage.setItem('token',t); render(); }
  else alert('invalid token');
}
setInterval(() => { document.getElementById('clock').textContent =
  new Date().toLocaleTimeString(); }, 1000);
setInterval(() => { if (token && !detail
  && !document.getElementById('dlg').open) render(); }, 5000);
async function refreshDagGraph() {
  // live task statuses on an OPEN dag detail without a full reload
  // (the list-view interval above deliberately skips detail views —
  // a reload would drop scroll position and the code-file selection)
  if (!token || !detail || detail.kind !== 'dag') return;
  const host = document.getElementById('dagraph');
  if (!host) return;
  const g = await api('graph', {id: detail.id});
  host.innerHTML = layerGraph(g.nodes, g.edges);
}
setInterval(refreshDagGraph, 5000);
render();
</script></body></html>
"""


def dashboard_html() -> str:
    return _DASHBOARD


__all__ = ['dashboard_html']
