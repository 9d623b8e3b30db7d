#include "json.h"

#include <cctype>
#include <cstdlib>

namespace egpu {
namespace {

class Parser {
 public:
  explicit Parser(const std::string& text) : s_(text) {}

  JsonPtr Parse() {
    JsonPtr v = Value();
    if (!v) return nullptr;
    Ws();
    if (pos_ != s_.size()) return nullptr;  // trailing garbage
    return v;
  }

 private:
  const std::string& s_;
  size_t pos_ = 0;

  void Ws() {
    while (pos_ < s_.size() && std::isspace(static_cast<unsigned char>(s_[pos_])))
      pos_++;
  }

  bool Eat(char c) {
    Ws();
    if (pos_ < s_.size() && s_[pos_] == c) {
      pos_++;
      return true;
    }
    return false;
  }

  bool Literal(const char* word) {
    size_t n = 0;
    while (word[n]) n++;
    if (s_.compare(pos_, n, word) != 0) return false;
    pos_ += n;
    return true;
  }

  JsonPtr Value() {
    Ws();
    if (pos_ >= s_.size()) return nullptr;
    char c = s_[pos_];
    if (c == '{') return Object();
    if (c == '[') return Array();
    if (c == '"') return String();
    if (c == 't' || c == 'f') return Bool();
    if (c == 'n') {
      if (!Literal("null")) return nullptr;
      auto v = std::make_shared<Json>();
      v->type = Json::kNull;
      return v;
    }
    return Number();
  }

  JsonPtr Object() {
    if (!Eat('{')) return nullptr;
    auto v = std::make_shared<Json>();
    v->type = Json::kObject;
    Ws();
    if (Eat('}')) return v;
    while (true) {
      Ws();
      JsonPtr key = String();
      if (!key || !Eat(':')) return nullptr;
      JsonPtr val = Value();
      if (!val) return nullptr;
      v->members[key->str_value] = val;
      if (Eat(',')) continue;
      if (Eat('}')) return v;
      return nullptr;
    }
  }

  JsonPtr Array() {
    if (!Eat('[')) return nullptr;
    auto v = std::make_shared<Json>();
    v->type = Json::kArray;
    Ws();
    if (Eat(']')) return v;
    while (true) {
      JsonPtr item = Value();
      if (!item) return nullptr;
      v->items.push_back(item);
      if (Eat(',')) continue;
      if (Eat(']')) return v;
      return nullptr;
    }
  }

  JsonPtr String() {
    Ws();
    if (pos_ >= s_.size() || s_[pos_] != '"') return nullptr;
    pos_++;
    auto v = std::make_shared<Json>();
    v->type = Json::kString;
    std::string out;
    while (pos_ < s_.size()) {
      char c = s_[pos_++];
      if (c == '"') {
        v->str_value = out;
        return v;
      }
      if (c == '\\') {
        if (pos_ >= s_.size()) return nullptr;
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
          case 'u':
            // No input (paths, env strings, ids) carries a \u escape:
            // skip its 4 hex digits rather than decode surrogates.
            if (pos_ + 4 > s_.size()) return nullptr;
            pos_ += 4;
            out += '?';
            break;
          default:
            return nullptr;
        }
      } else {
        out += c;
      }
    }
    return nullptr;  // unterminated
  }

  JsonPtr Bool() {
    auto v = std::make_shared<Json>();
    v->type = Json::kBool;
    if (Literal("true")) {
      v->bool_value = true;
      return v;
    }
    if (Literal("false")) {
      v->bool_value = false;
      return v;
    }
    return nullptr;
  }

  JsonPtr Number() {
    size_t start = pos_;
    if (pos_ < s_.size() && (s_[pos_] == '-' || s_[pos_] == '+')) pos_++;
    while (pos_ < s_.size() &&
           (std::isdigit(static_cast<unsigned char>(s_[pos_])) ||
            s_[pos_] == '.' || s_[pos_] == 'e' || s_[pos_] == 'E' ||
            s_[pos_] == '-' || s_[pos_] == '+'))
      pos_++;
    if (pos_ == start) return nullptr;
    auto v = std::make_shared<Json>();
    v->type = Json::kNumber;
    v->num_value = std::strtod(s_.substr(start, pos_ - start).c_str(), nullptr);
    return v;
  }
};

}  // namespace

JsonPtr Json::Parse(const std::string& text) { return Parser(text).Parse(); }

}  // namespace egpu
