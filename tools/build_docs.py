#!/usr/bin/env python
'''
Render the markdown manual (docs/*.md) to a static HTML site at
docs/_build/html/ -- the build/publish story for the docs (the
reference used Sphinx, docs/Makefile + conf.py upstream; this repo's
docs are plain markdown, rendered with the stdlib-adjacent ``markdown``
package so no extra tooling is required).

    python tools/build_docs.py        # or: make -C docs html
'''

import os
import re
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
DOCS = os.path.join(ROOT, 'docs')
OUT = os.path.join(DOCS, '_build', 'html')

PAGE = '''<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>{title} — kvarq_tpu</title>
<style>
 body {{ font: 16px/1.55 system-ui, sans-serif; color: #222;
        max-width: 56rem; margin: 0 auto; padding: 1rem 1.5rem 4rem; }}
 nav {{ font-size: .9rem; border-bottom: 1px solid #ddd;
       padding-bottom: .5rem; margin-bottom: 1.5rem; }}
 nav a {{ margin-right: .8rem; }}
 pre {{ background: #f6f6f6; padding: .7rem 1rem; overflow-x: auto;
       border-radius: 4px; }}
 code {{ background: #f3f3f3; padding: 0 .2em; border-radius: 3px;
        font-size: .92em; }}
 pre code {{ background: none; padding: 0; }}
 table {{ border-collapse: collapse; }}
 th, td {{ border: 1px solid #ccc; padding: .3rem .6rem;
          text-align: left; }}
 h1, h2, h3 {{ line-height: 1.25; }}
 a {{ color: #0a58ca; }}
</style>
</head>
<body>
<nav>{nav}</nav>
{body}
</body>
</html>
'''


def build():
    import markdown

    os.makedirs(OUT, exist_ok=True)
    pages = sorted(f for f in os.listdir(DOCS) if f.endswith('.md'))
    nav = ' '.join(
        '<a href="%s.html">%s</a>' % (os.path.splitext(f)[0],
                                      os.path.splitext(f)[0])
        for f in (['index.md'] + [p for p in pages if p != 'index.md']))

    for fname in pages:
        with open(os.path.join(DOCS, fname)) as fd:
            text = fd.read()
        # cross-page links: foo.md / foo.md#anchor -> foo.html...
        text = re.sub(r'\(([\w./-]+)\.md(#[\w-]*)?\)', r'(\1.html\2)', text)
        body = markdown.markdown(
            text, extensions=['tables', 'fenced_code'])
        title = fname[:-3]
        m = re.search(r'<h1[^>]*>(.*?)</h1>', body)
        if m:
            title = re.sub(r'<[^>]+>', '', m.group(1))
        out = os.path.join(OUT, fname[:-3] + '.html')
        with open(out, 'w') as fd:
            fd.write(PAGE.format(title=title, nav=nav, body=body))
        print('wrote', os.path.relpath(out, ROOT))

    # static assets (diagrams): docs/res/* -> _build/html/res/
    res = os.path.join(DOCS, 'res')
    if os.path.isdir(res):
        out_res = os.path.join(OUT, 'res')
        os.makedirs(out_res, exist_ok=True)
        for f in os.listdir(res):
            shutil.copy2(os.path.join(res, f), os.path.join(out_res, f))
            print('copied res/%s' % f)

    print('%d pages -> %s' % (len(pages), os.path.relpath(OUT, ROOT)))


def clean():
    shutil.rmtree(os.path.join(DOCS, '_build'), ignore_errors=True)
    print('cleaned docs/_build')


if __name__ == '__main__':
    if '--clean' in sys.argv:
        clean()
    else:
        build()
