"""Structural check of the web page's inline <script> (there is no JS
engine on either machine): bracket balancing that knows template literals
and tells a regex literal from a division. It catches the unbalanced-brace
and unterminated-string class of editing mistakes before they ship in
``apps/webui.INDEX_HTML``. A lexer good enough for this page, not a
parser; ``check_js`` is the JAX repository's ``tools/check_ui_js.py``
unchanged.

    python -m scrfd_arcface_facerecognition_tpu_torch.tools.check_ui_js
        (checks the port's page, apps/webui.INDEX_HTML)
    python -m scrfd_arcface_facerecognition_tpu_torch.tools.check_ui_js page.html
"""
import re
import sys


def check_js(src: str) -> None:
    # frames: "'" | '"' | '`' string modes, or ("code", entry) where entry
    # is depth['{'] right after the interpolation's '${' (None for the
    # top-level frame). An interpolation closes only when a '}' returns the
    # brace depth below its entry — a plain stack[-2]=='`' check would pop
    # at the FIRST '}' and misparse `${ ({a: 1}).a }`.
    stack = [("code", None)]
    depth = {"{": 0, "(": 0, "[": 0}
    pairs = {"}": "{", ")": "(", "]": "["}
    # a '/' starts a regex literal (not division) after these tokens
    regex_prefix = re.compile(
        r"(?:[=(\[{,;:!&|?+\-*%~^<>]|return|typeof|in|of|new|do|else|case"
        r"|void|delete|throw|yield|await)\s*$")
    i, esc, prev_code = 0, False, ""
    line = 1
    while i < len(src):
        c = src[i]
        if c == "\n":
            line += 1
        mode = stack[-1] if isinstance(stack[-1], str) else "code"
        if mode in ("'", '"', "`"):
            if esc:
                esc = False
            elif c == "\\":
                esc = True
            elif c == mode:
                stack.pop()
            elif mode == "`" and c == "$" and src[i + 1:i + 2] == "{":
                depth["{"] += 1
                stack.append(("code", depth["{"]))
                prev_code = ""
                i += 1
        else:                                   # code
            if c in "'\"`":
                stack.append(c)
            elif c == "/" and src[i + 1:i + 2] == "/":
                j = src.find("\n", i)
                i = j if j > 0 else len(src)
                continue
            elif c == "/" and regex_prefix.search(prev_code):
                # regex literal: skip to the closing unescaped '/', minding
                # character classes where '/' is literal
                i += 1
                in_class = resc = False
                while i < len(src):
                    rc = src[i]
                    if resc:
                        resc = False
                    elif rc == "\\":
                        resc = True
                    elif rc == "[":
                        in_class = True
                    elif rc == "]":
                        in_class = False
                    elif rc == "/" and not in_class:
                        break
                    elif rc == "\n":
                        raise AssertionError(
                            f"line {line}: unterminated regex literal")
                    i += 1
                while i + 1 < len(src) and src[i + 1].isalpha():
                    i += 1                      # flags
            else:
                if c in depth:
                    depth[c] += 1
                elif c in pairs:
                    depth[pairs[c]] -= 1
                    if depth[pairs[c]] < 0:
                        raise AssertionError(
                            f"line {line}: unmatched '{c}'")
                    entry = stack[-1][1]
                    if (c == "}" and entry is not None
                            and depth["{"] == entry - 1):
                        stack.pop()             # close of ${} interpolation
                if not c.isspace():
                    prev_code = (prev_code + c)[-8:]
        i += 1
    assert stack == [("code", None)], \
        f"unterminated string/template: {stack}"
    assert all(v == 0 for v in depth.values()), f"unbalanced: {depth}"


def script_of(html: str) -> str:
    m = re.search(r"<script>(.*)</script>", html, re.S)
    if not m:
        raise AssertionError("no <script> block found")
    return m.group(1)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv:
        with open(argv[0]) as f:
            html = f.read()
    else:
        from ..apps.webui import INDEX_HTML
        html = INDEX_HTML
    script = script_of(html)
    check_js(script)
    print(f"ui script ok ({len(script)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
