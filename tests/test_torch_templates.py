"""The PyTorch port's prompt templating against the JAX package's.

The card's machine has no Jinja2, so the port renders templates with its
own engine (``templates/engine.py``). Here it is held against Jinja2
through the JAX package's ``gotmpl.make_environment()``, byte for byte:
an expression corpus, the guesser's seven family templates, the Go
templates of ``tests/test_templates.py`` after ``go_template_to_jinja``,
chat templates in the style of public checkpoints, and (hypothesis)
message lists with roles, empty, multi-line and non-ASCII content and
tool calls. Where Jinja2 raises, the port raises. Then the template cache
and ``build_chat_prompt`` / ``build_completion_prompt`` /
``build_edit_prompt`` / ``apply_tokenizer_template`` against the JAX
package's over configs that take every branch, and the golden prompts
pinned in ``chip_smoke.py`` against the JAX package's rendering of the
same YAMLs.
"""

import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jinja2")
yaml = pytest.importorskip("yaml")

from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from localai_tpu.api import inference as jax_inf  # noqa: E402
from localai_tpu.api.schema import OpenAIRequest  # noqa: E402
from localai_tpu.config.guesser import FAMILY_SETTINGS  # noqa: E402
from localai_tpu.config.model_config import ModelConfig as JaxModelConfig  # noqa: E402
from localai_tpu.templates import chat as jax_chat  # noqa: E402
from localai_tpu.templates import gotmpl as jax_go  # noqa: E402
from localai_tpu.templates.cache import TemplateCache as JaxCache  # noqa: E402
from localai_tpu.templates.cache import TemplateType as JaxType  # noqa: E402
from localai_tpu.utils.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from localai_tpu_torch.api import openai as port_oa  # noqa: E402
from localai_tpu_torch.config import guesser as port_guesser  # noqa: E402
from localai_tpu_torch.config.model_config import ModelConfig  # noqa: E402
from localai_tpu_torch.config.yaml_subset import safe_load  # noqa: E402
from localai_tpu_torch.templates import chat as port_chat  # noqa: E402
from localai_tpu_torch.templates import gotmpl as port_go  # noqa: E402
from localai_tpu_torch.templates.cache import TemplateCache, TemplateType  # noqa: E402
from localai_tpu_torch.templates.engine import TemplateError  # noqa: E402
from localai_tpu_torch.utils.tokenizer import ByteTokenizer  # noqa: E402
from test_templates import CHATML, LLAMA3  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

JINJA = jax_go.make_environment()
PORT = port_go.make_environment()


def _render(env, src: str, ctx: dict):
    """("ok", text) or ("raises", None), parse and render together."""
    try:
        return "ok", env.from_string(src).render(**ctx)
    except Exception:  # noqa: BLE001 — any failure is a failure
        return "raises", None


def _same(src: str, **ctx) -> None:
    want = _render(JINJA, src, ctx)
    got = _render(PORT, src, ctx)
    assert got == want, (src, got, want)


CTX = dict(ms=[{"r": 1}, {"r": 0}], d={"a": 1}, s="x y",
           messages=[{"role": "system", "content": " hi "},
                     {"role": "user", "content": "q"}])
EXPRESSIONS = [
    '{% set c = 0 %}{% for i in range(3) %}{% set c = c + 1 %}{{ c }}{% endfor %}{{ c }}',
    "{% for i in range(2) %}{% if i == 0 %}{% set x = 'a' %}{% endif %}{{ x }}|{% endfor %}",
    '{% set x = 1 %}{% if true %}{% set x = 2 %}{% endif %}{{ x }}',
    '{{ undefined_thing.foo.bar }}|{{ (u|length) }}|{{ u is defined }}',
    '{{ u + 1 }}',
    "{{ 'a' ~ u ~ 'b' }}",
    '{{ u() }}',
    '{{ u < 1 }}',
    '{{ u == u2 }}',
    '{{ u|int }}',
    "{{ 'x' if false }}|",
    '{{ [1,2,3][1:] }}',
    "{{ {'a':1} }}",
    '{{ none }}{{ true }}',
    '{% for a, b in [[1,2],[3,4]] %}{{a}}{{b}}{% endfor %}',
    "{{ 'abc'.upper() }}{{ 'a b'.split() }}",
    '{{ d.items() }}',
    '{{ 1/2 }} {{ 7//2 }} {{ 2**3 }} {{ -7 % 3 }}',
    '{% for m in ms if m.r %}{{ loop.index }}/{{ loop.length }}{% else %}E{% endfor %}',
    "{{ raise_exception('x') }}",
    '{{ ns }}',
    '{% set ns = namespace(a=1) %}{% set ns.a = 2 %}{{ ns.a }}',
    '{% set x %}  hi {{ 1 }}{% endset %}[{{ x }}]',
    "{{ 'a' is string }}{{ 1 is number }}{{ {} is mapping }}{{ u is iterable }}{{ none is none }}",
    "{{ ms|selectattr('r')|list }}{{ ms|map(attribute='r')|join(',') }}",
    "{{ ms|selectattr('r', 'equalto', 1)|list }}",
    "{{ 'héllo'|tojson }}{{ {'b':1,'a':[1,2]}|tojson }}",
    "{{ 'a' in u }}",
    '{{ u in [1] }}',
    '{{ u.x.y is defined }}',
    "{{ x|default('d') }}{{ x|d('e') }}",
    "{% for x in 'ab' %}{{ loop.first }}{{ loop.last }}{{ loop.revindex }}{% endfor %}",
    'a\n{%- if true -%}\n  b  \n{%- endif %}\nc\n',
    '{{ 1 if 2 > 1 else 3 }}',
    '{{ not 1 == 2 }}',
    '{{ -3|abs }}',
    "{{ 'x' * 3 }}",
    "{{ 'a' 'b' }}",
    '{{ (1, 2) }}',
    '{{ [1,2] + [3] }}',
    "{{ 'a' + 1 }}",
    '{% raw %}{{ x }}{% endraw %}',
    '{# c #}x',
    "{{ ms[0]['r'] }}{{ ms[0].r }}{{ ms[-1].r }}",
    '{{ loop }}',
    '{% for i in [1] %}{% for j in [2,3] %}{{ loop.index }}{% endfor %}{{ loop.index }}{% endfor %}',
    "{{ messages[0]['content'] | trim }}",
    "{{ 'Hello World'|title }}{{ 'hello'|capitalize }}{{ 'aXa'|replace('a','b') }}",
    "{{ '%s-%d'|format('a', 3) }}",
    "{{ 'a,b'.split(',')|first }}{{ [1,2]|last }}",
    "{{ 5|string + 'x' }}",
    '{{ x.y() }}',
    "{{ 'abc'[::-1] }}",
    '{{ 3 is even }}{{ 3 is odd }}',
    '{{ 1 is sameas true }}{{ true is sameas true }}',
    '{% if x %}{% elif y %}Y{% else %}N{% endif %}',
    '{{ u.foo | tojson }}',
    '{{ [3,1,2]|sort }}{{ [1,1]|unique|list }}{{ [1,2]|sum }}{{ [1,2]|reverse|list }}',
    '{% for k, v in d.items() %}{{k}}={{v}};{% endfor %}',
    "{{ d.a }}{{ d['a'] }}{{ d.get('z', 'q') }}{{ d.keys()|list }}",
    "{{ 'x' ~ 1.5 ~ none }}",
    '{% set x = 5 %}{% for i in [1,2] %}{{ x }}{% set x = i %}{{ x }}{% endfor %}{{ x }}',
    '{{ x }}{% set x = 1 %}{{ x }}',
    '{% for i in [1,2] %}{% if i == 2 %}{{ y }}{% endif %}{% set y = i %}{% endfor %}',
    '{% for i in [1] %}{% for j in [1] %}{% set z = 3 %}{% endfor %}{{ z }}{% endfor %}',
    '{% set loop = 3 %}{{ loop }}',
    '{% for m in ms %}{{ loop.previtem }}{{ loop.nextitem }}|{% endfor %}',
    '{{ x is not defined }}{{ x is not none }}{{ not x is defined }}',
    '{{ 1 + 2 is odd }}',
    '{{ [1,2]|length + 1 }}',
    '{{ -1|abs }}',
    "{{ 'a' if x is defined else 'b' }}",
    '{{ ms|length > 1 and ms[0].r }}',
    "{% if messages[0]['role'] == 'system' %}{% set s = messages[0]['content'] %}{% endif %}{{ s }}",
    '{{ u.a.b() }}',
    '{{ ns.x }}',
    "{{ 'abc'|length }}",
    '{{ foo(1) }}',
    '{{ range(3)|list }}',
    '{{ dict(a=1) }}',
    '{{ 1 < 2 < 3 }}',
    '{{ 1 == 1.0 }}',
    "{{ 'a' < 'b' }}",
    "{{ x.y.z|default('q') }}",
    "{{ 'a'|default('b') }}",
    "{{ ''|default('b') }}",
    "{{ true and 'x' }}{{ false or 'y' }}{{ none or 0 }}",
    "{{ ms|map(attribute='r')|list }}",
    "{{ ms|map('string')|list }}",
    "{{ ms|rejectattr('r')|list }}",
    "{{ ms|selectattr('q', 'defined')|list }}",
    "{{ ['a','b']|join }}{{ [1,2]|join('-') }}",
    "{{ ms|join(',', attribute='r') }}",
    "{{ 'ab cd'|upper }}{{ 'AB'|lower }}",
    "{{ 1.5|int }}{{ '3'|int }}{{ 'x'|int }}",
    "{{ '  a  '.strip() }}|{{ 'a'.startswith('a') }}",
    '{{ d|items|list }}',
    '{{ 10 / 4 }}{{ 10 % 4 }}',
    "{{ 'x' in 'xyz' }}{{ 'q' not in ['q'] }}",
    '{%- for m in ms -%}\n  {{ m.r }}\n{%- endfor -%}\n',
    "{{- ' a ' -}}  ",
    '  {%- if true %} x {% endif -%}  y',
    '{% if true %}\n{% endif %}\n',
    '{{ d }}',
    "{{ ms[5] }}|{{ d.z }}|{{ d['z'] }}",
    "{{ 'ab'[5] }}",
    '{{ x[0] }}',
    '{{ ms[0].r is number }}',
    '{{ 1.0 }}{{ 1e3 }}{{ 0.1 + 0.2 }}',
    '{% for i in range(1, 6, 2) %}{{ i }}{% endfor %}',
    '{% for x in u %}a{% else %}b{% endfor %}',
    "{{ 'It''s' }}",
    '{% if x %}',
    '{% endif %}',
    '{% for x in y %}{% endif %}',
    '{% macroo x %}',
    '{{ x|nofilter }}',
    '{{ x is notatest }}',
    '{{ }}',
    '{{ 1 + }}',
    '{% set %}',
    '{% for %}{% endfor %}',
    '{{ [1, 2 }}',
    '{% break %}',
    "{{ 'a' }",
    '{# unclosed',
    '{{ 1 / 0 }}',
    '{{ none.x }}',
    '{{ none() }}',
    '{{ d.a.b.c }}',
    '{% set d.a = 1 %}',
    "{{ 'a' is sameas 'a' }}",
    '{{ 3|items|list }}',
    '{{ x|tojson(indent=2) }}',
    '{{ [1]|first }}{{ []|first }}{{ []|last }}',
    "{{ 'abc'|list }}",
    '{% for a, b in [1] %}{% endfor %}',
    "{{ s.split(' ')[1] }}",
    '{{ s[0:1] }}{{ s[:1] }}{{ s[1:] }}{{ s[::2] }}',
    '{{ messages[1:]|length }}',
    '{{ (1 if true else 2) + 3 }}',
    '{{ not true or true }}',
    '{{ 2 * 3 + 4 ~ 5 }}',
    '{{ 2 ** 3 ** 2 }}',
    '{{ -2 ** 2 }}',
    "{{ 'a' ~ 1 + 2 }}",
    '{{ 10 - 2 - 3 }}',
    '{{ 1 - -1 }}',
    "{{ [1,2,3][-1] }}{{ d['a'] + 1 }}",
    "{{ {'a': {'b': 1}} }}",
    "{{ {'a': {'b': 1}}['a']['b'] }}",
    '{{ "}}" }}',
    '{% set x = "%}" %}{{ x }}',
    "{{ 'a\\nb' }}",
    '{{ "tab\\there" }}',
    "{{ '\\u00e9' }}",
    'x\r\ny',
    "{{ 'a' }}\r\n",
    '{%- raw -%}  {{ x }}  {%- endraw -%}  z',
    'a  {#- c -#}  b',
    '{%+ if true %}x{% endif %}',
    "{% for i in range(3) %}{{ loop.cycle('a','b') }}{% endfor %}",
    '{{ loop.index }}',
    '{% set a, b = 1, 2 %}{{ a }}{{ b }}',
    '{% set a, b = [3, 4] %}{{ a + b }}',
    '{% set t = 1, 2 %}{{ t }}',
    "{{ x if x else 'n' }}",
    "{{ [1, 2, 3]|select('odd')|list }}",
    "{{ [1, 2, 3]|reject('odd')|list }}",
    "{{ ms|selectattr('r', '==', 0)|list }}",
    "{{ [[1],[2]]|map('first')|list }}",
    "{{ ['a','B']|map('upper')|join }}",
    "{{ {'b':1,'a':2}|dictsort }}",
    "{{ 'x\ny'|indent(2) }}",
    "{{ 'x\ny\n'|indent(2, true) }}",
    "{{ 1 is divisibleby 1 }}{{ x is undefined }}",
    '{{ 3 is integer }}{{ 3.0 is float }}{{ true is boolean }}',
    '{{ [] is sequence }}{{ 1 is sequence }}',
    '{{ 1 in [1] }}{{ 1 is in [1] }}',
    "{{ 'a' is eq 'a' }}",
    "{{ messages|selectattr('role', 'equalto', 'user')|list|length }}",
    "{{ x.y.z }}{{ x['y']['z'] }}",
    '{% if x.y %}a{% else %}b{% endif %}',
    '{{ x.y|trim }}|{{ x|title }}|{{ x|upper }}',
    '{{ x|length }}{{ x|list }}',
    '{% for k in d %}{{ k }}{% endfor %}',
    '{{ d|length }}',
    "{{ 'a'.join(['x','y']) }}",
    "{{ 'ABC'.lower().strip('a') }}",
    "{{ 'x'.rstrip() }}",
    "{{ ' x '.lstrip() }}|",
    "{{ 'a-b'.replace('-', '+') }}",
    "{{ 'abc'.endswith('c') }}",
    "{{ 'a b'.title() }}",
    '{{ [1,2].index(2) }}',
    '{{ d.values()|list }}',
    "{{ 'x'|string|length }}",
    "{{ 3|float }}{{ 'x'|float }}",
    '{{ 1|string ~ 2 }}',
    '{% if 1 %}{% if 2 %}n{% endif %}{% endif %}',
    "{{ 0 or u or 'z' }}",
    "{{ (u or 'z') }}",
    '{% for x in [1,2] if x > 1 %}{{ loop.first }}{% endfor %}',
    '{% for x in [] %}{% else %}empty{% endfor %}',
    '{% for x in [1] %}{% else %}empty{% endfor %}',
    '{%- for x in [1,2] %}\n{{ x }}\n{%- endfor %}',
    '{% if true -%}\n\n  x\n\n{%- endif %}',
    "{{ 'x' }}\n",
    "\n\n{{ 'x' }}\n\n",
    '{% if false %}\n{% endif %}x',
    "{{ d.get('a') }}{{ d.get('q') }}",
    '{{ none|string }}',
    '{{ true|string|lower }}',
    '{{ [1,[2,3]]|tojson }}',
    "{{ {'k': none, 'v': true}|tojson }}",
    '{{ 1.5|tojson }}',
    '{{ \'é"\\n\'|tojson }}',
    '{{ d|toJson }}',
    "{{ x|default('y', true) }}",
    "{{ x|d('y', true) }}",
    "{{ 0|d('y', true) }}",
    '{{ ms|length is odd }}',
    '{{ ms[0].r == 1 and ms[1].r == 0 }}',
    '{{ (ms[0].r == 1) != (ms[1].r == 0) }}',
    "{{ d['a'] is not none }}",
    '{{ 1 is not sameas 2 }}',
    '{{ [1][0:1] }}',
    "{{ d.a }}{{ d.b|default('x') }}",
    "{{ 'abc' 'def' 'g' }}",
    '{{ 1_000 }}',
    '{{ 0x10 }}',
    '{{ 1.5e2 }}',
    '{{ 3 / 2 * 2 }}',
    '{{ 7 % 3 ** 2 }}',
]


@pytest.mark.parametrize("src", EXPRESSIONS,
                         ids=[f"expr{i}" for i in range(len(EXPRESSIONS))])
def test_engine_renders_or_raises_as_jinja2(src):
    _same(src, **CTX)


LLAMA3_INSTRUCT = (
    "{% set loop_messages = messages %}{% for message in loop_messages %}"
    "{% set content = '<|start_header_id|>' + message['role'] + "
    "'<|end_header_id|>\\n\\n'+ message['content'] | trim + '<|eot_id|>' %}"
    "{% if loop.index0 == 0 %}{% set content = bos_token + content %}"
    "{% endif %}{{ content }}{% endfor %}{% if add_generation_prompt %}"
    "{{ '<|start_header_id|>assistant<|end_header_id|>\\n\\n' }}{% endif %}")
MISTRAL_INSTRUCT = (
    "{{ bos_token }}{% for message in messages %}"
    "{% if (message['role'] == 'user') != (loop.index0 % 2 == 0) %}"
    "{{ raise_exception('Conversation roles must alternate "
    "user/assistant/user/assistant/...') }}{% endif %}"
    "{% if message['role'] == 'user' %}"
    "{{ '[INST] ' + message['content'] + ' [/INST]' }}"
    "{% elif message['role'] == 'assistant' %}"
    "{{ message['content'] + eos_token}}{% else %}"
    "{{ raise_exception('Only user and assistant roles are supported!') }}"
    "{% endif %}{% endfor %}")
CHATML_QWEN2 = (
    "{% for message in messages %}{% if loop.first and messages[0]['role'] "
    "!= 'system' %}{{ '<|im_start|>system\\nYou are a helpful assistant."
    "<|im_end|>\\n' }}{% endif %}{{'<|im_start|>' + message['role'] + '\\n' "
    "+ message['content'] + '<|im_end|>' + '\\n'}}{% endfor %}"
    "{% if add_generation_prompt %}{{ '<|im_start|>assistant\\n' }}"
    "{% endif %}")
GEMMA = (
    "{{ bos_token }}{% if messages[0]['role'] == 'system' %}"
    "{{ raise_exception('System role not supported') }}{% endif %}"
    "{% for message in messages %}{% if (message['role'] == 'user') != "
    "(loop.index0 % 2 == 0) %}{{ raise_exception('Conversation roles must "
    "alternate user/assistant/user/assistant/...') }}{% endif %}"
    "{% if (message['role'] == 'assistant') %}{% set role = 'model' %}"
    "{% else %}{% set role = message['role'] %}{% endif %}"
    "{{ '<start_of_turn>' + role + '\\n' + message['content'] | trim + "
    "'<end_of_turn>\\n' }}{% endfor %}{% if add_generation_prompt %}"
    "{{'<start_of_turn>model\\n'}}{% endif %}")
ZEPHYR = (
    "{% for message in messages %}\n{% if message['role'] == 'user' %}\n"
    "{{ '<|user|>\\n' + message['content'] + eos_token }}\n"
    "{% elif message['role'] == 'system' %}\n"
    "{{ '<|system|>\\n' + message['content'] + eos_token }}\n"
    "{% elif message['role'] == 'assistant' %}\n"
    "{{ '<|assistant|>\\n'  + message['content'] + eos_token }}\n"
    "{% endif %}\n{% if loop.last and add_generation_prompt %}\n"
    "{{ '<|assistant|>' }}\n{% endif %}\n{% endfor %}")
QWEN25_TOOLS = (
    "{%- if tools %}\n    {{- '<|im_start|>system\\n' }}\n"
    "    {%- if messages[0]['role'] == 'system' %}\n"
    "        {{- messages[0]['content'] }}\n    {%- else %}\n"
    "        {{- 'You are a helpful assistant.' }}\n    {%- endif %}\n"
    "    {{- \"\\n\\n# Tools\\n\\n<tools>\" }}\n"
    "    {%- for tool in tools %}\n        {{- \"\\n\" }}\n"
    "        {{- tool | tojson }}\n    {%- endfor %}\n"
    "    {{- \"\\n</tools><|im_end|>\\n\" }}\n{%- else %}\n"
    "    {%- if messages[0]['role'] == 'system' %}\n"
    "        {{- '<|im_start|>system\\n' + messages[0]['content'] + "
    "'<|im_end|>\\n' }}\n    {%- endif %}\n{%- endif %}\n"
    "{%- for message in messages %}\n"
    "    {%- if (message.role == \"user\") or (message.role == \"system\" "
    "and not loop.first) or (message.role == \"assistant\" and not "
    "message.tool_calls) %}\n"
    "        {{- '<|im_start|>' + message.role + '\\n' + message.content + "
    "'<|im_end|>' + '\\n' }}\n"
    "    {%- elif message.role == \"assistant\" %}\n"
    "        {{- '<|im_start|>' + message.role }}\n"
    "        {%- if message.content %}\n"
    "            {{- '\\n' + message.content }}\n        {%- endif %}\n"
    "        {%- for tool_call in message.tool_calls %}\n"
    "            {%- if tool_call.function is defined %}\n"
    "                {%- set tool_call = tool_call.function %}\n"
    "            {%- endif %}\n"
    "            {{- '\\n<tool_call>\\n{\"name\": \"' }}\n"
    "            {{- tool_call.name }}\n"
    "            {{- '\", \"arguments\": ' }}\n"
    "            {{- tool_call.arguments | tojson }}\n"
    "            {{- '}\\n</tool_call>' }}\n        {%- endfor %}\n"
    "        {{- '<|im_end|>\\n' }}\n"
    "    {%- elif message.role == \"tool\" %}\n"
    "        {%- if (loop.index0 == 0) or (messages[loop.index0 - 1].role "
    "!= \"tool\") %}\n            {{- '<|im_start|>user' }}\n"
    "        {%- endif %}\n"
    "        {{- '\\n<tool_response>\\n' }}\n"
    "        {{- message.content }}\n"
    "        {{- '\\n</tool_response>' }}\n"
    "        {%- if loop.last or (messages[loop.index0 + 1].role != "
    "\"tool\") %}\n            {{- '<|im_end|>\\n' }}\n"
    "        {%- endif %}\n    {%- endif %}\n{%- endfor %}\n"
    "{%- if add_generation_prompt %}\n"
    "    {{- '<|im_start|>assistant\\n' }}\n{%- endif %}\n")
DEEPSEEK_NS = (
    "{% set ns = namespace(system_prompt='', is_tool=false, "
    "is_first=true) %}{%- for message in messages %}"
    "{%- if message['role'] == 'system' %}"
    "{% set ns.system_prompt = ns.system_prompt + message['content'] %}"
    "{%- endif %}{%- endfor %}{{ bos_token }}{{ ns.system_prompt }}"
    "{%- for message in messages %}{%- if message['role'] == 'user' %}"
    "{%- set ns.is_tool = false -%}"
    "{{ '<｜User｜>' + message['content'] }}"
    "{%- elif message['role'] == 'assistant' and message['content'] is not "
    "none %}{% set content = message['content'] %}"
    "{% if '</think>' in content %}"
    "{% set content = content.split('</think>')[-1] %}{% endif %}"
    "{{ '<｜Assistant｜>' + content + '<｜end▁of▁sentence｜>' }}"
    "{%- endif %}{%- endfor -%}"
    "{% if add_generation_prompt %}{{ '<｜Assistant｜>' }}{% endif %}")
PHI3_SELECT = (
    "{% set sys = messages|selectattr('role', 'equalto', 'system')|list %}"
    "{% if sys|length > 0 %}<|system|>\n{{ sys[0]['content'] }}<|end|>\n"
    "{% endif %}{% for m in messages|rejectattr('role', 'equalto', "
    "'system') %}<|{{ m.role }}|>\n{{ m.content }}<|end|>\n"
    "{% if loop.last %}{{ messages|map(attribute='role')|join(',') }}"
    "{% endif %}{% endfor %}{% if add_generation_prompt %}<|assistant|>\n"
    "{% endif %}")
HF_STYLE = {"llama3-instruct": LLAMA3_INSTRUCT,
            "mistral-instruct": MISTRAL_INSTRUCT,
            "chatml-qwen2": CHATML_QWEN2, "gemma": GEMMA, "zephyr": ZEPHYR,
            "qwen2.5-tools": QWEN25_TOOLS, "deepseek-namespace": DEEPSEEK_NS,
            "phi3-selectattr": PHI3_SELECT}

MESSAGE_SETS = {
    "system-user": [{"role": "system", "content": "Be brief."},
                    {"role": "user", "content": "Why is the sky blue?"}],
    "alternating": [{"role": "user", "content": "hi"},
                    {"role": "assistant", "content": "hello</think>there"},
                    {"role": "user", "content": "  again  "}],
    "tools": [{"role": "user", "content": "weather?"},
              {"role": "assistant", "content": None, "tool_calls": [
                  {"id": "c1", "type": "function", "function": {
                      "name": "get_weather",
                      "arguments": "{\"unit\": \"celsius\"}"}}]},
              {"role": "tool", "content": "21 degrees"},
              {"role": "tool", "content": "sunny"}],
    "empty-content": [{"role": "user", "content": ""}],
    "multiline-unicode": [{"role": "system", "content": "Réponds\n\nen français."},
                          {"role": "user", "content": "日本語?\n- a\n- b\t"}],
    "user-only": [{"role": "user", "content": "Say hello."}],
}
FAMILIES = sorted(FAMILY_SETTINGS)


def _chat_ctx(messages, agp=True):
    return dict(messages=messages, add_generation_prompt=agp,
                bos_token="<s>", eos_token="</s>",
                tools=[{"name": "get_weather", "description": "été"}])


def test_family_settings_are_the_jax_packages():
    assert port_guesser.FAMILY_SETTINGS == FAMILY_SETTINGS


@pytest.mark.parametrize("agp", [True, False], ids=["gen", "nogen"])
@pytest.mark.parametrize("msgs", sorted(MESSAGE_SETS))
@pytest.mark.parametrize("family", FAMILIES)
def test_family_templates_render_as_jinja2(family, msgs, agp):
    _same(FAMILY_SETTINGS[family]["chat_template"],
          **_chat_ctx(MESSAGE_SETS[msgs], agp))


@pytest.mark.parametrize("agp", [True, False], ids=["gen", "nogen"])
@pytest.mark.parametrize("msgs", sorted(MESSAGE_SETS))
@pytest.mark.parametrize("name", sorted(HF_STYLE))
def test_checkpoint_chat_templates_render_as_jinja2(name, msgs, agp):
    _same(HF_STYLE[name], **_chat_ctx(MESSAGE_SETS[msgs], agp))


def _message_data(msg, idx, n):
    fcall = msg.get("tool_calls") or msg.get("function_call")
    return {"SystemPrompt": "sys", "Role": "", "RoleName": msg["role"],
            "Content": msg.get("content") or "", "FunctionCall": fcall,
            "FunctionName": msg.get("name", ""), "LastMessage": idx == n - 1,
            "Function": False, "MessageIndex": idx}


@pytest.mark.parametrize("name,src", [("llama3", LLAMA3), ("chatml", CHATML)])
def test_go_templates_transpile_and_render_as_jinja2(name, src):
    jinja_src = jax_go.go_template_to_jinja(src)
    assert port_go.go_template_to_jinja(src) == jinja_src
    assert port_go.looks_like_go_template(src)
    for messages in MESSAGE_SETS.values():
        for i, m in enumerate(messages):
            data = _message_data(m, i, len(messages))
            _same(jinja_src, **data, _data=data)


_TEXT = st.one_of(st.just(""), st.text(max_size=40),
                  st.text(alphabet="ab \n\t<|>é日", max_size=20))
_TOOL_CALLS = st.lists(st.fixed_dictionaries({
    "id": st.text(alphabet="abc123", max_size=4),
    "type": st.just("function"),
    "function": st.fixed_dictionaries({
        "name": st.sampled_from(["get_weather", "set_mode"]),
        "arguments": st.sampled_from(["{}", "{\"on\": true}"])})}),
    min_size=1, max_size=2)
_MESSAGE = st.builds(
    lambda role, content, calls: {"role": role, "content": content,
                                  **({"tool_calls": calls} if calls else {})},
    st.sampled_from(["system", "user", "assistant", "tool"]),
    st.one_of(st.none(), _TEXT), st.one_of(st.none(), _TOOL_CALLS))
ALL_CHAT_TEMPLATES = ([FAMILY_SETTINGS[f]["chat_template"] for f in FAMILIES]
                      + [HF_STYLE[k] for k in sorted(HF_STYLE)])
GO_MESSAGE_TEMPLATES = [jax_go.go_template_to_jinja(t) for t in (LLAMA3,
                                                                 CHATML)]


@settings(max_examples=150, deadline=None,
          suppress_health_check=list(HealthCheck))
@given(st.lists(_MESSAGE, max_size=5), st.booleans())
def test_chat_templates_over_message_lists(messages, agp):
    """Every chat template of the corpus, and the transpiled Go message
    templates, render each generated conversation as Jinja2 does (or
    raise where it raises)."""
    for src in ALL_CHAT_TEMPLATES:
        _same(src, **_chat_ctx(messages, agp))
    for src in GO_MESSAGE_TEMPLATES:
        for i, m in enumerate(messages):
            data = _message_data(m, i, len(messages))
            _same(src, **data, _data=data)


IDIOM_MESSAGES = [
    {"role": "system", "content": "S"}, {"role": "user", "content": "hi"},
    {"role": "assistant", "content": "<think>\nx\n</think>\n\nok",
     "tool_calls": [{"id": "abcdefghi", "function": {
         "name": "f", "arguments": {"a": "1", "b": "2"}}}]},
    {"role": "tool", "content": "<tool_response>r"},
    {"role": "user", "content": "q"}]
# constructs of recent checkpoints' chat templates (reasoning and tool
# templates), each on its own
IDIOMS = [
    "{%- set ns = namespace(multi_step_tool=true, last_query_index="
    "messages|length - 1) %}{%- for message in messages[::-1] %}"
    "{%- set index = (messages|length - 1) - loop.index0 %}"
    "{%- if ns.multi_step_tool and message.role == 'user' and "
    "message.content is string and not(message.content.startswith("
    "'<tool_response>') and message.content.endswith('</tool_response>')) "
    "%}{%- set ns.multi_step_tool = false %}"
    "{%- set ns.last_query_index = index %}{%- endif %}{%- endfor %}"
    "{{ ns.last_query_index }}",
    "{% for m in messages %}{% set content = m.content %}"
    "{% if '</think>' in content %}{{ content.split('</think>')[0]"
    ".rstrip('\\n').split('<think>')[-1].lstrip('\\n') }}|"
    "{{ content.split('</think>')[-1].lstrip('\\n') }}{% endif %}"
    "{% endfor %}",
    "{%- set user_messages = messages | selectattr('role', 'equalto', "
    "'user') | list %}{% for message in messages %}"
    "{% if message == user_messages[-1] %}LAST{% endif %}{% endfor %}",
    "{% for tool in tools %}{% for key, val in tool.items() if key != "
    "'return' %}{% if val is string %}{{ key }}={{ val }};{% endif %}"
    "{% endfor %}{% endfor %}",
    "{% for m in messages %}{% for tc in m.tool_calls %}"
    "{{ tc.id|length != 9 }}{% for k, v in tc.function.arguments | items %}"
    "{{ k + '=\"' + v + '\"' }}{% endfor %}{% endfor %}{% endfor %}",
    "{{ enable_thinking is defined and enable_thinking is false }}"
    "{{ false is false }}",
    "{%- if not date_string is defined %}{%- set date_string = "
    "'26 Jul 2024' %}{%- endif %}{{ date_string }}",
    "{%- set system_message = messages[0]['content']|trim %}"
    "{%- set messages = messages[1:] %}{{ system_message }}"
    "{{ messages|length }}",
    "{{ messages[0]['content'][0] }}{{ (messages|first).role }}",
    "{%- for message in messages %}{{- '<|im_start|>' + message.role }}"
    "{%- if message.tool_calls %}{%- for tc in message.tool_calls %}"
    "{{ tc.function.arguments | tojson }}{% endfor %}{% endif %}"
    "{%- endfor %}",
]


@pytest.mark.parametrize("src", IDIOMS,
                         ids=[f"idiom{i}" for i in range(len(IDIOMS))])
def test_checkpoint_template_idioms_render_as_jinja2(src):
    _same(src, messages=IDIOM_MESSAGES,
          tools=[{"name": "f", "description": "d", "return": "x", "n": 1}])


ERRORS = [
    "{% if x %}", "{% endif %}", "{% for x in y %}{% endif %}",
    "{% macroo x %}", "{{ x|nofilter }}", "{{ x is notatest }}", "{{ }}",
    "{{ 1 + }}", "{% set %}", "{{ [1, 2 }}", "{% break %}", "{# unclosed",
    "{{ 'a' }", "{{ raise_exception('bad roles') }}", "{{ u() }}",
    "{{ u + 1 }}", "{{ u < 1 }}", "{{ 'a' + 1 }}", "{{ 1 / 0 }}",
    "{{ none() }}", "{% set d.a = 1 %}", "{{ x|tojson(indent=2) }}",
    "{{ u.foo|tojson }}", "{{ 3|items|list }}",
    "{% for a, b in [1] %}{% endfor %}", "{{ u|int }}",
]


@pytest.mark.parametrize("src", ERRORS,
                         ids=[f"err{i}" for i in range(len(ERRORS))])
def test_engine_raises_where_jinja2_raises(src):
    with pytest.raises(Exception):
        JINJA.from_string(src).render(d={"a": 1})
    with pytest.raises((TemplateError, TypeError, ValueError,
                        ZeroDivisionError)):
        PORT.from_string(src).render(d={"a": 1})


@pytest.mark.parametrize("src", ["{{ ''.__class__ }}",
                                 "{{ d.__class__.__mro__ }}",
                                 "{{ '{0.__class__}'.format(d) }}",
                                 "{{ loop._items }}"])
def test_dunders_and_str_format_are_out_of_reach(src):
    """A template comes from a user YAML or a checkpoint: the port's
    engine gives it no way to reach Python internals."""
    try:
        out = PORT.from_string(src).render(d={"a": 1})
    except TemplateError:
        return
    assert "class" not in out and "items" not in out


# -- the template cache ----------------------------------------------------


@pytest.fixture()
def tdir(tmp_path):
    models = tmp_path / "models"
    models.mkdir()
    (models / "a.tmpl").write_text("tmpl {{.Input}}")
    (models / "a.jinja").write_text("jinja {{ Input }}")
    (models / "b.jinja").write_text("{% if Input %}b={{ Input }}{% endif %}")
    (models / "c.j2").write_text("c2 {{.Input}}\n")
    (tmp_path / "outside.tmpl").write_text("outside {{.Input}}")
    return models


@pytest.mark.parametrize("name", ["a", "b", "c", "inline {{.Input}}!",
                                  "no-such-file", "x" * 250])
def test_template_cache_resolves_names_as_the_jax_one(tdir, name):
    data = {"Input": "hi", "SystemPrompt": ""}
    ours = TemplateCache(tdir).evaluate(TemplateType.CHAT, name, data)
    ref = JaxCache(tdir).evaluate(JaxType.CHAT, name, data)
    assert ours == ref
    assert TemplateCache(tdir).exists_file(name) == \
        JaxCache(tdir).exists_file(name)


def test_template_cache_refuses_traversal(tdir):
    assert TemplateCache(tdir).exists_file("../outside") == \
        JaxCache(tdir).exists_file("../outside")
    for cache, tt in ((TemplateCache(tdir), TemplateType.CHAT),
                      (JaxCache(tdir), JaxType.CHAT)):
        with pytest.raises(ValueError, match="escapes"):
            cache.evaluate(tt, "../outside", {"Input": "x"})


# -- prompt builders ---------------------------------------------------------

CHAT_CONFIGS = {
    "llama3-message-and-chat": {"template": {
        "chat_message": LLAMA3,
        "chat": "<|begin_of_text|>{{.Input}}\n<|start_header_id|>assistant"
                "<|end_header_id|>\n\n"}},
    "chatml-message": {"template": {"chat_message": CHATML,
                                    "join_chat_messages_by_character": ""}},
    "roles-suppress-system": {
        "system_prompt": "You are kind.",
        "roles": {"system": "SYS: ", "user": "U: ", "assistant": "A: "},
        "template": {"chat": "{{if not .SuppressSystemPrompt}}"
                             "{{.SystemPrompt}}\n{{end}}{{.Input}}\nA:"}},
    "blank-message-skips": {"template": {
        "chat_message": "{{if eq .RoleName \"system\"}}{{else}}"
                        "{{.RoleName}}: {{.Content}}{{end}}"}},
    "functions-template": {"system_prompt": "sys", "template": {
        "chat_message": "{{.RoleName}}{{if .Function}}[call]{{end}}: "
                        "{{.Content}}",
        "chat": "CHAT {{.Input}}",
        "functions": "{{range .Functions}}{{.name}};{{end}}|{{.Input}}"}},
    "tool-call-fallback": {
        "roles": {"assistant_function_call": "FC:", "user": "U:",
                  "tool": "T:"}},
    "model-file-template": {"model": "mf"},
    "model-file-jinja-and-chat": {"model": "mj", "template": {
        "chat": "outer<{{.Input}}>"}},
    "broken-message-template": {"template": {
        "chat_message": "{{ .Content | nofilter }}", "chat": "[{{.Input}}]"}},
    "broken-outer-template": {"roles": {"user": "U:"},
                              "template": {"chat": "{{ .Input + 1 }}"}},
    "join-by-space": {"template": {"join_chat_messages_by_character": " "}},
}
CHAT_MESSAGES = [
    {"role": "system", "content": "Answer tersely."},
    {"role": "user", "content": "Weather in Nice?"},
    {"role": "assistant", "content": None, "tool_calls": [
        {"id": "c1", "type": "function", "function": {
            "name": "get_weather", "arguments": "{\"unit\":\"celsius\"}"}}]},
    {"role": "tool", "content": "21C"},
    {"role": "user", "content": [{"type": "text", "text": "And "},
                                 {"type": "text", "text": "tomorrow?"}]},
]
FUNCTIONS = [{"name": "get_weather", "description": "", "parameters": {}},
             {"name": "set_mode"}]


@pytest.fixture()
def models_dir(tmp_path):
    (tmp_path / "mf.tmpl").write_text("<file>{{.Input}}</file>")
    (tmp_path / "mj.jinja").write_text("jinja-file {{ Input }}")
    return tmp_path


def _configs(doc):
    doc = {"name": "m", **doc}
    return ModelConfig.from_dict(dict(doc)), JaxModelConfig(**doc)


@pytest.mark.parametrize("tools", [False, True], ids=["chat", "tools"])
@pytest.mark.parametrize("name", sorted(CHAT_CONFIGS))
def test_build_chat_prompt_equals_the_jax_one(models_dir, name, tools):
    ours, ref = _configs(CHAT_CONFIGS[name])
    kw = dict(functions=FUNCTIONS if tools else None,
              use_function_template=tools, grammar_active=tools)
    for messages in (CHAT_MESSAGES, CHAT_MESSAGES[:2], CHAT_MESSAGES[1:2]):
        assert port_chat.build_chat_prompt(
            TemplateCache(models_dir), ours, messages, **kw) == \
            jax_chat.build_chat_prompt(JaxCache(models_dir), ref, messages,
                                       **kw)


def test_model_file_template_wraps_the_prompt(models_dir):
    """A ``<model>.tmpl`` beside ``model: <model>`` is the outer template,
    as on the JAX package (the port used to ignore it)."""
    ours, _ = _configs({"model": "mf"})
    out = port_chat.build_chat_prompt(TemplateCache(models_dir), ours,
                                      [{"role": "user", "content": "hi"}])
    assert out == "<file>hi</file>"


COMPLETION_CONFIGS = {
    "none": {},
    "completion": {"system_prompt": "S", "template": {
        "completion": "{{.SystemPrompt}}|Q: {{.Input}}\nA:",
        "edit": "{{.Instruction}} >> {{.Input}} <<"}},
    "model-file": {"model": "mf"},
    "broken": {"template": {"completion": "{{ .Input | nofilter }}",
                            "edit": "{{ .Input + 1 }}"}},
}


@pytest.mark.parametrize("name", sorted(COMPLETION_CONFIGS))
def test_completion_and_edit_prompts_equal_the_jax_ones(models_dir, name):
    ours, ref = _configs(COMPLETION_CONFIGS[name])
    ours_c, ref_c = TemplateCache(models_dir), JaxCache(models_dir)
    for prompt in ("Once upon", "", "multi\nline é"):
        assert port_chat.build_completion_prompt(ours_c, ours, prompt) == \
            jax_chat.build_completion_prompt(ref_c, ref, prompt)
        assert port_chat.build_edit_prompt(ours_c, ours, prompt, "Fix.") == \
            jax_chat.build_edit_prompt(ref_c, ref, prompt, "Fix.")


@pytest.mark.parametrize("agp", [True, False])
@pytest.mark.parametrize("family", FAMILIES)
def test_apply_tokenizer_template_equals_the_jax_one(family, agp):
    tmpl = FAMILY_SETTINGS[family]["chat_template"]
    for messages in MESSAGE_SETS.values():
        try:
            want = ("ok", jax_chat.apply_tokenizer_template(
                JaxByteTokenizer(), messages, add_generation_prompt=agp,
                chat_template=tmpl))
        except Exception:  # noqa: BLE001
            want = ("raises", None)
        try:
            got = ("ok", port_chat.apply_tokenizer_template(
                ByteTokenizer(), messages, add_generation_prompt=agp,
                chat_template=tmpl))
        except Exception:  # noqa: BLE001
            got = ("raises", None)
        assert got == want
    for fn, tok in ((port_chat.apply_tokenizer_template, ByteTokenizer()),
                    (jax_chat.apply_tokenizer_template, JaxByteTokenizer())):
        with pytest.raises(ValueError, match="no chat template"):
            fn(tok, MESSAGE_SETS["user-only"])


@settings(max_examples=100, deadline=None,
          suppress_health_check=list(HealthCheck))
@given(st.lists(st.builds(
    lambda role, content, extra: {"role": role, "content": content, **extra},
    st.sampled_from(["system", "user", "assistant", "tool"]),
    st.one_of(st.none(), _TEXT),
    st.sampled_from([{}, {"name": "n"}, {"tool_call_id": "t1"},
                     {"function_call": {"name": "f", "arguments": "{}"}},
                     {"function_call": {"arguments": "{}"}},
                     {"tool_calls": [{"function": {"name": "f"}}]},
                     {"tool_calls": [{"index": 0, "id": "x", "type":
                                      "function", "function": {
                                          "arguments": "1", "name": "g"},
                                      "extra": None}]}])),
    max_size=4))
def test_chat_messages_are_dumped_as_the_jax_schema_dumps_them(messages):
    """What templates see of a request's messages: the JAX package
    validates them into its schema and dumps them without nulls."""
    want = [m.model_dump(exclude_none=True) for m in
            OpenAIRequest.model_validate({"messages": messages}).messages]
    got = port_oa.chat_messages(messages)
    assert got == want
    assert [list(m) for m in got] == [list(m) for m in want]


# -- the golden prompts of chip_smoke.py ------------------------------------


class _ByteModel:
    tokenizer = JaxByteTokenizer()


def _jax_prompts(models_dir):
    """The JAX package's prompts for the templated serve's requests, as
    its chat, completions and edits endpoints build them."""
    cfgs = {}
    for text in (chip_smoke.TEMPLATED_YAML, chip_smoke.CHAT_TEMPLATE_YAML):
        doc = yaml.safe_load(text)
        cfgs[doc["name"]] = JaxModelConfig(**doc)
    cache = JaxCache(models_dir)
    out = []
    for body in chip_smoke.TEMPLATED_CHATS:
        req = OpenAIRequest.model_validate(body)
        cfg = cfgs[req.model]
        tctx = jax_inf.prepare_tools(_ByteModel(), cfg, req)
        msgs = [m.model_dump(exclude_none=True) for m in req.messages]
        if cfg.template.use_tokenizer_template or (
                cfg.template.chat_template and tctx is None):
            out.append(jax_chat.apply_tokenizer_template(
                _ByteModel.tokenizer, msgs,
                chat_template=cfg.template.chat_template))
        else:
            out.append(jax_chat.build_chat_prompt(
                cache, cfg, msgs,
                functions=tctx.functions if tctx else None,
                use_function_template=tctx is not None,
                grammar_active=tctx is not None
                and tctx.constraint is not None))
    comp, edit = chip_smoke.TEMPLATED_COMPLETION, chip_smoke.TEMPLATED_EDIT
    out += [jax_chat.build_completion_prompt(cache, cfgs[comp["model"]], p)
            for p in comp["prompt"]]
    out.append(jax_chat.build_edit_prompt(cache, cfgs[edit["model"]],
                                          edit["prompt"],
                                          edit["instruction"]))
    return out


def test_chip_smoke_yamls_read_as_pyyaml_reads_them():
    for text in (chip_smoke.TEMPLATED_YAML, chip_smoke.CHAT_TEMPLATE_YAML):
        assert safe_load(text) == yaml.safe_load(text)
    assert yaml.safe_load(chip_smoke.TEMPLATED_YAML)["template"][
        "chat_message"] == LLAMA3
    assert yaml.safe_load(chip_smoke.CHAT_TEMPLATE_YAML)["template"][
        "chat_template"] == FAMILY_SETTINGS["llama3"]["chat_template"]


def test_chip_smoke_golden_prompts_are_the_jax_packages(tmp_path):
    assert _jax_prompts(tmp_path) == chip_smoke.TEMPLATED_GOLDEN


def test_chip_smoke_golden_prompts_are_the_ports(tmp_path):
    """The port's own endpoint functions reach the same prompts (the
    chat prompt through ``_chat_prompt``, tools through
    ``prepare_tools``)."""
    from localai_tpu_torch.api import inference as port_inf
    from localai_tpu_torch.config.loader import ConfigLoader

    chip_smoke.write_models_dir(tmp_path, {
        chip_smoke.TEMPLATED: chip_smoke.TEMPLATED_YAML,
        chip_smoke.CHAT_TEMPLATED: chip_smoke.CHAT_TEMPLATE_YAML})
    loader = ConfigLoader(tmp_path)
    loader.load_from_path()

    class SM:
        tokenizer = ByteTokenizer()
        templates = TemplateCache(tmp_path)

    out = []
    for body in chip_smoke.TEMPLATED_CHATS:
        sm = SM()
        sm.config = loader.get(body["model"])
        tctx = port_inf.prepare_tools(sm, body)
        out.append(port_oa._chat_prompt(
            sm, port_oa.chat_messages(body["messages"]), tctx))
    cfg = loader.get(chip_smoke.TEMPLATED)
    out += [port_chat.build_completion_prompt(SM.templates, cfg, p)
            for p in chip_smoke.TEMPLATED_COMPLETION["prompt"]]
    edit = chip_smoke.TEMPLATED_EDIT
    out.append(port_chat.build_edit_prompt(SM.templates, cfg, edit["prompt"],
                                           edit["instruction"]))
    assert out == chip_smoke.TEMPLATED_GOLDEN
