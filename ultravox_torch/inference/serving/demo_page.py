"""Built-in browser demo (reference: tools/gradio_demo.py — text+audio chat).

A single static page served at ``/`` by the API server: text chat plus WAV
file upload (and mic capture where the browser records WAV), streaming
responses over SSE from ``/v1/chat/completions``. No gradio dependency.
"""

DEMO_HTML = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>ultravox-torch demo</title>
<style>
  body { font-family: system-ui, sans-serif; max-width: 780px; margin: 2rem auto; padding: 0 1rem; background: #101418; color: #e6e6e6; }
  h1 { font-size: 1.2rem; }
  #chat { border: 1px solid #2a3340; border-radius: 8px; padding: 1rem; min-height: 300px; }
  .msg { margin: .5rem 0; white-space: pre-wrap; }
  .user { color: #8ec7ff; }
  .assistant { color: #b5f1c2; }
  .meta { color: #8a93a0; font-size: .8rem; }
  #controls { display: flex; gap: .5rem; margin-top: 1rem; }
  input[type=text] { flex: 1; padding: .5rem; background: #1a222c; color: #e6e6e6; border: 1px solid #2a3340; border-radius: 6px; }
  button { padding: .5rem 1rem; background: #2d5f8a; color: white; border: 0; border-radius: 6px; cursor: pointer; }
  button:disabled { opacity: .5; }
</style>
</head>
<body>
<h1>ultravox-torch — speech+text chat</h1>
<div id="chat"></div>
<div id="controls">
  <input type="text" id="text" placeholder="Type a message; attach a WAV to ask about audio"/>
  <input type="file" id="audio" accept=".wav,audio/wav"/>
  <button id="send">Send</button>
</div>
<div class="meta" id="status"></div>
<script>
const history = [];
function addMsg(role, text) {
  const div = document.createElement('div');
  div.className = 'msg ' + role;
  div.textContent = (role === 'user' ? 'you: ' : 'model: ') + text;
  document.getElementById('chat').appendChild(div);
  return div;
}
async function fileToB64(file) {
  const buf = await file.arrayBuffer();
  let s = '';
  const bytes = new Uint8Array(buf);
  for (let i = 0; i < bytes.length; i += 0x8000)
    s += String.fromCharCode.apply(null, bytes.subarray(i, i + 0x8000));
  return btoa(s);
}
document.getElementById('send').onclick = async () => {
  const textEl = document.getElementById('text');
  const audioEl = document.getElementById('audio');
  const btn = document.getElementById('send');
  const text = textEl.value.trim();
  if (!text && !audioEl.files.length) return;
  btn.disabled = true;
  const content = [];
  if (text) content.push({type: 'text', text: text + (audioEl.files.length ? ' ' : '')});
  if (audioEl.files.length) {
    content.push({type: 'input_audio',
      input_audio: {data: await fileToB64(audioEl.files[0]), format: 'wav'}});
  }
  addMsg('user', text + (audioEl.files.length ? ' [audio]' : ''));
  history.push({role: 'user', content: content.length === 1 && text ? text : content});
  const div = addMsg('assistant', '');
  const t0 = performance.now();
  let first = null;
  const resp = await fetch('/v1/chat/completions', {
    method: 'POST', headers: {'Content-Type': 'application/json'},
    body: JSON.stringify({model: 'ultravox-torch', messages: history,
                          max_tokens: 256, stream: true})});
  const reader = resp.body.getReader();
  const dec = new TextDecoder();
  let acc = '', buf = '';
  while (true) {
    const {done, value} = await reader.read();
    if (done) break;
    buf += dec.decode(value, {stream: true});
    const events = buf.split('\\n\\n'); buf = events.pop();
    for (const ev of events) {
      if (!ev.startsWith('data: ') || ev.includes('[DONE]')) continue;
      const delta = JSON.parse(ev.slice(6)).choices[0].delta.content;
      if (delta) {
        if (first === null) first = performance.now() - t0;
        acc += delta;
        div.textContent = 'model: ' + acc;
      }
    }
  }
  history.push({role: 'assistant', content: acc});
  document.getElementById('status').textContent =
    'TTFT ' + (first || 0).toFixed(0) + ' ms · total ' +
    (performance.now() - t0).toFixed(0) + ' ms';
  textEl.value = ''; audioEl.value = ''; btn.disabled = false;
};
</script>
</body>
</html>
"""


VOICE_HTML = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>ultravox-torch voice</title>
<style>
  body { font-family: system-ui, sans-serif; max-width: 720px; margin: 2rem auto; padding: 0 1rem; background: #101418; color: #e6e6e6; }
  h1 { font-size: 1.2rem; }
  #chat { border: 1px solid #2a3340; border-radius: 8px; padding: 1rem; min-height: 280px; }
  .msg { margin: .5rem 0; white-space: pre-wrap; }
  .user { color: #8ec7ff; }
  .assistant { color: #b5f1c2; }
  .meta { color: #8a93a0; font-size: .8rem; }
  button { padding: .6rem 1.2rem; background: #2d5f8a; color: white; border: 0; border-radius: 6px; cursor: pointer; margin-top: 1rem; }
  #level { height: 6px; background: #1a222c; border-radius: 3px; margin-top: .6rem; }
  #level > div { height: 100%; width: 0%; background: #3fae6a; border-radius: 3px; }
</style>
</head>
<body>
<h1>ultravox-torch — real-time voice (VAD reply-on-pause)</h1>
<p class="meta">Talk, then pause; the model replies. Mic audio streams as
16 kHz PCM over a WebSocket; the server's energy VAD segments utterances.</p>
<div id="chat"></div>
<div id="level"><div></div></div>
<button id="mic">start microphone</button>
<button id="reset">reset conversation</button>
<script>
const chat = document.getElementById('chat');
const levelBar = document.querySelector('#level > div');
let ws = null, ctx = null, stream = null, node = null, running = false;
let current = null;

function add(cls, text) {
  const d = document.createElement('div');
  d.className = 'msg ' + cls;
  d.textContent = (cls === 'user' ? 'you: ' : 'model: ') + text;
  chat.appendChild(d);
  chat.scrollTop = chat.scrollHeight;
  return d;
}

function connect() {
  const proto = location.protocol === 'https:' ? 'wss://' : 'ws://';
  ws = new WebSocket(proto + location.host + '/ws/voice');
  ws.binaryType = 'arraybuffer';
  ws.onmessage = (ev) => {
    const m = JSON.parse(ev.data);
    if (m.type === 'utterance') {
      add('user', '[' + m.seconds.toFixed(1) + 's of speech]');
      current = add('assistant', '');
    } else if (m.type === 'token' && current) {
      current.textContent += m.text;
    } else if (m.type === 'turn_end' && current) {
      if (m.ttft_s) {
        const meta = document.createElement('span');
        meta.className = 'meta';
        meta.textContent = '  (ttft ' + (m.ttft_s * 1000).toFixed(0) + ' ms)';
        current.appendChild(meta);
      }
      current = null;
    }
  };
}

async function startMic() {
  connect();
  stream = await navigator.mediaDevices.getUserMedia({audio: {channelCount: 1}});
  ctx = new AudioContext();
  const source = ctx.createMediaStreamSource(stream);
  node = ctx.createScriptProcessor(4096, 1, 1);
  const ratio = ctx.sampleRate / 16000;
  node.onaudioprocess = (e) => {
    const input = e.inputBuffer.getChannelData(0);
    let peak = 0;
    const n = Math.floor(input.length / ratio);
    const pcm = new Int16Array(n);
    for (let i = 0; i < n; i++) {
      const v = input[Math.floor(i * ratio)];
      peak = Math.max(peak, Math.abs(v));
      pcm[i] = Math.max(-32768, Math.min(32767, v * 32768));
    }
    levelBar.style.width = Math.min(100, peak * 300) + '%';
    if (ws && ws.readyState === 1) ws.send(pcm.buffer);
  };
  source.connect(node);
  node.connect(ctx.destination);
  running = true;
  document.getElementById('mic').textContent = 'stop microphone';
}

document.getElementById('mic').onclick = async () => {
  if (!running) { await startMic(); }
  else {
    if (node) node.disconnect();
    if (stream) stream.getTracks().forEach(t => t.stop());
    if (ws) { ws.send(JSON.stringify({type: 'flush'})); }
    running = false;
    document.getElementById('mic').textContent = 'start microphone';
  }
};
document.getElementById('reset').onclick = () => {
  if (ws && ws.readyState === 1) ws.send(JSON.stringify({type: 'reset'}));
  chat.innerHTML = '';
};
</script>
</body>
</html>
"""
