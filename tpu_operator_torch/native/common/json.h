// Minimal JSON DOM: parse, mutate, serialize — no external dependencies.
//
// Exists for the OCI hook (gpu_oci_hook), which must read and edit a
// container's arbitrary config.json. Numbers are kept as their raw source
// text so round-tripping a config never mangles values we do not touch.
#pragma once

#include <cctype>
#include <cstdio>
#include <map>
#include <memory>
#include <string>
#include <utility>
#include <vector>

namespace gpuop {
namespace json {

class Value;
using ValuePtr = std::shared_ptr<Value>;

enum class Type { Null, Bool, Number, String, Array, Object };

class Value {
 public:
  Type type = Type::Null;
  bool boolean = false;
  std::string number;  // raw text, e.g. "1", "-2.5e3"
  std::string str;
  std::vector<ValuePtr> arr;
  // insertion-ordered object (vector of pairs keeps user key order stable)
  std::vector<std::pair<std::string, ValuePtr>> obj;

  static ValuePtr MakeNull() { return std::make_shared<Value>(); }
  static ValuePtr MakeBool(bool b) {
    auto v = std::make_shared<Value>();
    v->type = Type::Bool;
    v->boolean = b;
    return v;
  }
  static ValuePtr MakeNumber(long long n) {
    auto v = std::make_shared<Value>();
    v->type = Type::Number;
    v->number = std::to_string(n);
    return v;
  }
  static ValuePtr MakeString(const std::string& s) {
    auto v = std::make_shared<Value>();
    v->type = Type::String;
    v->str = s;
    return v;
  }
  static ValuePtr MakeArray() {
    auto v = std::make_shared<Value>();
    v->type = Type::Array;
    return v;
  }
  static ValuePtr MakeObject() {
    auto v = std::make_shared<Value>();
    v->type = Type::Object;
    return v;
  }

  // Object access. Get returns nullptr when missing or not an object.
  ValuePtr Get(const std::string& key) const {
    for (const auto& kv : obj)
      if (kv.first == key) return kv.second;
    return nullptr;
  }
  void Set(const std::string& key, ValuePtr v) {
    for (auto& kv : obj) {
      if (kv.first == key) {
        kv.second = std::move(v);
        return;
      }
    }
    obj.emplace_back(key, std::move(v));
  }
  // Get existing child object/array or create it (for nested edits).
  ValuePtr GetOrCreate(const std::string& key, Type t) {
    ValuePtr v = Get(key);
    if (v == nullptr || v->type != t) {
      v = std::make_shared<Value>();
      v->type = t;
      Set(key, v);
    }
    return v;
  }

  long long AsInt(long long dflt = 0) const {
    if (type != Type::Number) return dflt;
    try {
      return std::stoll(number);
    } catch (...) {
      return dflt;
    }
  }
};

// ---------------------------------------------------------------------------
// Parser

class Parser {
 public:
  explicit Parser(const std::string& text) : s_(text) {}

  ValuePtr Parse(std::string* err) {
    ValuePtr v = ParseValue(err);
    if (v == nullptr) return nullptr;
    SkipWs();
    if (pos_ != s_.size()) {
      *err = "trailing characters at offset " + std::to_string(pos_);
      return nullptr;
    }
    return v;
  }

 private:
  const std::string& s_;
  size_t pos_ = 0;

  void SkipWs() {
    while (pos_ < s_.size() && std::isspace(static_cast<unsigned char>(s_[pos_])))
      ++pos_;
  }
  bool Match(const char* lit) {
    size_t n = std::char_traits<char>::length(lit);
    if (s_.compare(pos_, n, lit) == 0) {
      pos_ += n;
      return true;
    }
    return false;
  }

  ValuePtr Fail(std::string* err, const std::string& msg) {
    *err = msg + " at offset " + std::to_string(pos_);
    return nullptr;
  }

  ValuePtr ParseValue(std::string* err) {
    SkipWs();
    if (pos_ >= s_.size()) return Fail(err, "unexpected end of input");
    char c = s_[pos_];
    if (c == '{') return ParseObject(err);
    if (c == '[') return ParseArray(err);
    if (c == '"') return ParseString(err);
    if (Match("true")) return Value::MakeBool(true);
    if (Match("false")) return Value::MakeBool(false);
    if (Match("null")) return Value::MakeNull();
    return ParseNumber(err);
  }

  ValuePtr ParseObject(std::string* err) {
    ++pos_;  // '{'
    ValuePtr v = Value::MakeObject();
    SkipWs();
    if (pos_ < s_.size() && s_[pos_] == '}') {
      ++pos_;
      return v;
    }
    while (true) {
      SkipWs();
      if (pos_ >= s_.size() || s_[pos_] != '"')
        return Fail(err, "expected object key");
      ValuePtr key = ParseString(err);
      if (key == nullptr) return nullptr;
      SkipWs();
      if (pos_ >= s_.size() || s_[pos_] != ':') return Fail(err, "expected ':'");
      ++pos_;
      ValuePtr val = ParseValue(err);
      if (val == nullptr) return nullptr;
      v->obj.emplace_back(key->str, val);
      SkipWs();
      if (pos_ < s_.size() && s_[pos_] == ',') {
        ++pos_;
        continue;
      }
      if (pos_ < s_.size() && s_[pos_] == '}') {
        ++pos_;
        return v;
      }
      return Fail(err, "expected ',' or '}'");
    }
  }

  ValuePtr ParseArray(std::string* err) {
    ++pos_;  // '['
    ValuePtr v = Value::MakeArray();
    SkipWs();
    if (pos_ < s_.size() && s_[pos_] == ']') {
      ++pos_;
      return v;
    }
    while (true) {
      ValuePtr el = ParseValue(err);
      if (el == nullptr) return nullptr;
      v->arr.push_back(el);
      SkipWs();
      if (pos_ < s_.size() && s_[pos_] == ',') {
        ++pos_;
        continue;
      }
      if (pos_ < s_.size() && s_[pos_] == ']') {
        ++pos_;
        return v;
      }
      return Fail(err, "expected ',' or ']'");
    }
  }

  ValuePtr ParseString(std::string* err) {
    ++pos_;  // '"'
    std::string out;
    while (pos_ < s_.size()) {
      char c = s_[pos_++];
      if (c == '"') {
        ValuePtr v = Value::MakeString(out);
        return v;
      }
      if (c == '\\') {
        if (pos_ >= s_.size()) return Fail(err, "bad escape");
        char e = s_[pos_++];
        switch (e) {
          case '"': out += '"'; break;
          case '\\': out += '\\'; break;
          case '/': out += '/'; break;
          case 'b': out += '\b'; break;
          case 'f': out += '\f'; break;
          case 'n': out += '\n'; break;
          case 'r': out += '\r'; break;
          case 't': out += '\t'; break;
          case 'u': {
            if (pos_ + 4 > s_.size()) return Fail(err, "bad \\u escape");
            unsigned code = 0;
            for (int i = 0; i < 4; ++i) {
              char h = s_[pos_++];
              code <<= 4;
              if (h >= '0' && h <= '9') code |= h - '0';
              else if (h >= 'a' && h <= 'f') code |= h - 'a' + 10;
              else if (h >= 'A' && h <= 'F') code |= h - 'A' + 10;
              else return Fail(err, "bad hex digit in \\u escape");
            }
            // UTF-8 encode (surrogate pairs handled as two \u escapes by
            // emitting each half; OCI configs are ASCII in practice)
            if (code < 0x80) {
              out += static_cast<char>(code);
            } else if (code < 0x800) {
              out += static_cast<char>(0xC0 | (code >> 6));
              out += static_cast<char>(0x80 | (code & 0x3F));
            } else {
              out += static_cast<char>(0xE0 | (code >> 12));
              out += static_cast<char>(0x80 | ((code >> 6) & 0x3F));
              out += static_cast<char>(0x80 | (code & 0x3F));
            }
            break;
          }
          default:
            return Fail(err, "bad escape");
        }
        continue;
      }
      out += c;
    }
    return Fail(err, "unterminated string");
  }

  ValuePtr ParseNumber(std::string* err) {
    size_t start = pos_;
    if (pos_ < s_.size() && s_[pos_] == '-') ++pos_;
    while (pos_ < s_.size() &&
           (std::isdigit(static_cast<unsigned char>(s_[pos_])) ||
            s_[pos_] == '.' || s_[pos_] == 'e' || s_[pos_] == 'E' ||
            s_[pos_] == '+' || s_[pos_] == '-'))
      ++pos_;
    if (pos_ == start) return Fail(err, "unexpected character");
    auto v = std::make_shared<Value>();
    v->type = Type::Number;
    v->number = s_.substr(start, pos_ - start);
    return v;
  }
};

inline ValuePtr Parse(const std::string& text, std::string* err) {
  return Parser(text).Parse(err);
}

// ---------------------------------------------------------------------------
// Serializer

inline void EscapeTo(const std::string& s, std::string* out) {
  for (char c : s) {
    switch (c) {
      case '"': *out += "\\\""; break;
      case '\\': *out += "\\\\"; break;
      case '\n': *out += "\\n"; break;
      case '\r': *out += "\\r"; break;
      case '\t': *out += "\\t"; break;
      default:
        if (static_cast<unsigned char>(c) < 0x20) {
          char buf[8];
          std::snprintf(buf, sizeof(buf), "\\u%04x", c);
          *out += buf;
        } else {
          *out += c;
        }
    }
  }
}

inline void SerializeTo(const ValuePtr& v, std::string* out, int indent,
                        int depth) {
  const std::string pad(static_cast<size_t>(indent) * depth, ' ');
  const std::string padIn(static_cast<size_t>(indent) * (depth + 1), ' ');
  const char* nl = indent > 0 ? "\n" : "";
  switch (v->type) {
    case Type::Null: *out += "null"; break;
    case Type::Bool: *out += v->boolean ? "true" : "false"; break;
    case Type::Number: *out += v->number; break;
    case Type::String:
      *out += '"';
      EscapeTo(v->str, out);
      *out += '"';
      break;
    case Type::Array: {
      if (v->arr.empty()) {
        *out += "[]";
        break;
      }
      *out += '[';
      *out += nl;
      for (size_t i = 0; i < v->arr.size(); ++i) {
        *out += padIn;
        SerializeTo(v->arr[i], out, indent, depth + 1);
        if (i + 1 < v->arr.size()) *out += ',';
        *out += nl;
      }
      *out += pad;
      *out += ']';
      break;
    }
    case Type::Object: {
      if (v->obj.empty()) {
        *out += "{}";
        break;
      }
      *out += '{';
      *out += nl;
      for (size_t i = 0; i < v->obj.size(); ++i) {
        *out += padIn;
        *out += '"';
        EscapeTo(v->obj[i].first, out);
        *out += "\":";
        if (indent > 0) *out += ' ';
        SerializeTo(v->obj[i].second, out, indent, depth + 1);
        if (i + 1 < v->obj.size()) *out += ',';
        *out += nl;
      }
      *out += pad;
      *out += '}';
      break;
    }
  }
}

inline std::string Serialize(const ValuePtr& v, int indent = 2) {
  std::string out;
  SerializeTo(v, &out, indent, 0);
  if (indent > 0) out += '\n';
  return out;
}

}  // namespace json
}  // namespace gpuop
